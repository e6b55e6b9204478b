"""L2 — preprocessing / alignment.

The pipeline's one global invariant lives here: the gene order is the
SORTED intersection of the network's and expression file's gene sets
(ref: G2Vec.py:420-426). Every downstream index — edge endpoints, embedding
rows, L-group indices, output row order — is in this order.
"""
from __future__ import annotations

from typing import Dict, List

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
    """Keep directed edges with both endpoints common, in file order and
    direction (ref: G2Vec.py:393-402), renumbered into ``common_genes``:
    the result's names are the whole common list, not just genes with
    surviving edges (ref: G2Vec.py:400-401), so its ``src`` and ``dst``
    index the common order (ref: G2Vec.py:379-390; the graph is NOT
    symmetrized).
    """
    index = {g: i for i, g in enumerate(common_genes)}
    lut = np.fromiter((index.get(g, -1) for g in network.names),
                      dtype=np.int32, count=len(network.names))
    src, dst = lut[network.src], lut[network.dst]
    keep = (src >= 0) & (dst >= 0)
    return NetworkData(names=list(common_genes), src=src[keep],
                       dst=dst[keep], parser=network.parser)


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


def subsample_patients(data: ExpressionData, fraction: float,
                       seed: int, with_replacement: bool = False) -> ExpressionData:
    """Keep a stratified, seeded ``fraction`` of patients per label class
    (ref: ``g2vec_tpu/preprocess.py`` ``subsample_patients``, the same rows
    for the same seed).

    Per label class, ``max(2, round(fraction * n_class))`` patients are
    kept (2 is the floor the ddof=1 t-score needs), chosen by a seeded
    permutation of the class's positions in file order; the kept rows keep
    their file order. With ``with_replacement=True`` the same count is
    drawn with replacement per class (a bootstrap resample), redrawn until
    the class has at least 2 distinct patients; rows stay in ascending
    file order, duplicates adjacent.
    """
    if data.label is None:
        raise ValueError("subsample_patients needs matched labels "
                         "(call match_labels first)")
    if not (0.0 < fraction <= 1.0):
        raise ValueError(f"subsample fraction must be in (0,1], got {fraction}")
    rng = np.random.default_rng(seed)
    if with_replacement:
        parts = []
        for cls in (0, 1):
            pos = np.nonzero(data.label == cls)[0]
            if pos.size < 2:
                raise ValueError(
                    f"label class {cls} has only {pos.size} patient(s); "
                    f"cannot subsample")
            n_draw = min(pos.size, max(2, int(round(fraction * pos.size))))
            # One rng, consumed in class order (0 then 1).
            draw = rng.choice(pos, size=n_draw, replace=True)
            while np.unique(draw).size < 2:
                draw = rng.choice(pos, size=n_draw, replace=True)
            parts.append(draw)
        return _rows(data, np.sort(np.concatenate(parts)))
    keep = np.zeros(len(data.label), dtype=bool)
    for cls in (0, 1):
        pos = np.nonzero(data.label == cls)[0]
        if pos.size < 2:
            raise ValueError(
                f"label class {cls} has only {pos.size} patient(s); "
                f"cannot subsample")
        n_keep = min(pos.size, max(2, int(round(fraction * pos.size))))
        keep[np.sort(rng.permutation(pos)[:n_keep])] = True
    return _rows(data, keep)


def fold_assignments(labels: np.ndarray, n_folds: int, seed: int) -> np.ndarray:
    """Stratified fold ids, one per patient row (ref: ``fold_assignments``
    of ``g2vec_tpu/preprocess.py``): each label class is permuted by one
    seeded rng (class 0, then 1) and dealt round-robin across the folds.
    Every class must keep >= 2 patients in each training split and put
    >= 1 in each held-out fold."""
    if labels is None:
        raise ValueError("fold_assignments needs matched labels")
    if n_folds < 2:
        raise ValueError(f"n_folds must be >= 2, got {n_folds}")
    folds = np.full(len(labels), -1, dtype=np.int32)
    rng = np.random.default_rng(seed)
    for cls in (0, 1):
        pos = np.nonzero(labels == cls)[0]
        if pos.size < n_folds:
            raise ValueError(
                f"label class {cls} has {pos.size} patient(s); cannot "
                f"stratify into {n_folds} folds")
        max_in_fold = -(-pos.size // n_folds)  # ceil
        if pos.size - max_in_fold < 2:
            raise ValueError(
                f"label class {cls} has {pos.size} patient(s); a "
                f"{n_folds}-fold training split would drop below 2")
        order = rng.permutation(pos)
        folds[order] = np.arange(order.size, dtype=np.int32) % n_folds
    return folds


def fold_cohort(data: ExpressionData, n_folds: int, fold: int,
                seed: int) -> ExpressionData:
    """The training cohort of one CV fold: every patient not in ``fold``
    of the seeded ``fold_assignments`` partition."""
    if not (0 <= fold < n_folds):
        raise ValueError(f"fold must be in [0, {n_folds}), got {fold}")
    return _rows(data, fold_assignments(data.label, n_folds, seed) != fold)


def permute_labels(labels: np.ndarray, seed: int) -> np.ndarray:
    """Seeded label shuffle (a permutation-null draw); input untouched."""
    return np.random.default_rng(seed).permutation(labels)


def select_cohort(data: ExpressionData, spec) -> ExpressionData:
    """The patient cohort a run's ``spec`` asks for (a config, or a batch
    lane: anything with ``patient_subsample``, ``subsample_seed``,
    ``subsample_mode``, ``cv_folds`` and ``cv_fold``): a bootstrap draw
    (fraction 0 meaning the full class size), a CV fold's training
    cohort, a stratified subset, or ``data`` itself when none is set."""
    if spec.subsample_mode == "bootstrap":
        return subsample_patients(data, spec.patient_subsample or 1.0,
                                  spec.subsample_seed, with_replacement=True)
    if spec.subsample_mode == "fold":
        return fold_cohort(data, spec.cv_folds, spec.cv_fold,
                           spec.subsample_seed)
    if spec.patient_subsample:
        return subsample_patients(data, spec.patient_subsample,
                                  spec.subsample_seed)
    return data


def _rows(data: ExpressionData, rows: np.ndarray) -> ExpressionData:
    """``data`` restricted to ``rows`` (a boolean mask or row indices)."""
    return ExpressionData(sample=data.sample[rows].copy(), gene=data.gene,
                          expr=np.ascontiguousarray(data.expr[rows]),
                          label=data.label[rows].copy(), parser=data.parser)


def make_gene2idx(genes: np.ndarray) -> Dict[str, int]:
    """Gene symbol -> global index (ref: G2Vec.py:414-418)."""
    return {g: i for i, g in enumerate(genes)}
