"""L2 — preprocessing / alignment.

The pipeline's one global invariant lives here: the gene order is the
SORTED intersection of the network's and expression file's gene sets
(ref: G2Vec.py:420-426). Every downstream index — edge endpoints, embedding
rows, L-group indices, output row order — is in this order.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from g2vec_tpu_torch.io.readers import ExpressionData, NetworkData


class SampleMismatchError(ValueError):
    """An expression-file sample has no clinical label (ref: G2Vec.py:432-433)."""


def match_labels(clinical: Dict[str, int], samples: np.ndarray) -> np.ndarray:
    """Map expression-file sample order -> int labels (ref: G2Vec.py:428-434)."""
    missing = [s for s in samples if s not in clinical]
    if missing:
        preview = ", ".join(missing[:5])
        raise SampleMismatchError(
            f"{len(missing)} expression sample(s) have no clinical label "
            f"(first few: {preview}). Please check sample names.")
    return np.array([clinical[s] for s in samples], dtype=np.int32)


def find_common_genes(network_genes: set, data_genes: np.ndarray) -> List[str]:
    """Sorted intersection — defines the global gene index (ref: G2Vec.py:420-426)."""
    return sorted(set(network_genes) & set(data_genes))


def restrict_network(network: NetworkData, common_genes: List[str]) -> NetworkData:
    """Keep directed edges with both endpoints common (ref: G2Vec.py:393-402).

    The result's gene set is the whole common set, not just genes with
    surviving edges (ref: G2Vec.py:400-401).
    """
    common = set(common_genes)
    edges = [e for e in network.edges if e[0] in common and e[1] in common]
    return NetworkData(edges=edges, genes=common)


def restrict_data(data: ExpressionData, common_genes: List[str]) -> ExpressionData:
    """Reorder/clip expression columns to the sorted common list (ref: G2Vec.py:404-412)."""
    gene2idx = {g: i for i, g in enumerate(data.gene)}
    idx = np.array([gene2idx[g] for g in common_genes], dtype=np.int64)
    return ExpressionData(
        sample=data.sample.copy(),
        gene=np.array(common_genes),
        expr=np.ascontiguousarray(data.expr[:, idx]),
        label=None if data.label is None else data.label.copy(),
    )


def make_gene2idx(genes: np.ndarray) -> Dict[str, int]:
    """Gene symbol -> global index (ref: G2Vec.py:414-418)."""
    return {g: i for i, g in enumerate(genes)}


def edges_to_indices(network: NetworkData,
                     gene2idx: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list -> (src_idx, dst_idx) int32 arrays, file order preserved.

    Direction comes from file column order (ref: G2Vec.py:379-390); the
    graph is NOT symmetrized.
    """
    if not network.edges:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    src = np.array([gene2idx[e[0]] for e in network.edges], dtype=np.int32)
    dst = np.array([gene2idx[e[1]] for e in network.edges], dtype=np.int32)
    return src, dst
