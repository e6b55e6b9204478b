"""Scenario reducers: the replicates' outputs into one stability table.

The port's copy of ``g2vec_tpu/stats/reduce.py`` (pure numpy, float64 on
the host: the reduction runs once over small per-replicate artifacts and
has to be reproducible, not fast). Each ``reduce_*`` returns ``(columns,
rows, extras)``, every cell of ``rows`` already a string ("%.6f" floats,
"%d" counts, "na" for a gene no replicate selected), so
``write_stability`` only joins bytes.

The statistics, as the JAX package pins them:

- permutation p-values use the add-one estimator ``p = (1 + #{r:
  t_null >= t_obs}) / (1 + R)``: never 0, and a gene of constant
  expression (t = 0 everywhere, all ties) gets p = 1;
- BH-FDR q-values are the reversed running minimum of ``p * m / rank``
  over the stable p-ordering, capped at 1;
- a replicate's rank of a gene is the 1-based line of its FIRST entry in
  the replicate's biomarker file (a gene can top both L-group blocks; it
  counts once);
- the rank variance is taken with ddof=0 over the replicates that
  selected the gene.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def np_tscores(expr_good: np.ndarray, expr_poor: np.ndarray) -> np.ndarray:
    """Float64 host twin of ``ops/stats.tscores`` (absolute
    pooled-variance t per gene), term for term, so the observed statistic
    and the permutation nulls come from one formula."""
    g = np.asarray(expr_good, dtype=np.float64)
    p = np.asarray(expr_poor, dtype=np.float64)
    n0, n1 = g.shape[0], p.shape[0]
    m0, m1 = g.mean(axis=0), p.mean(axis=0)
    s0, s1 = g.std(axis=0, ddof=1), p.std(axis=0, ddof=1)
    pooled = ((n0 - 1) * s0 ** 2 + (n1 - 1) * s1 ** 2) / (n0 + n1 - 2)
    d1 = np.sqrt(pooled)
    d2 = np.sqrt(1.0 / n0 + 1.0 / n1)
    ok = (d1 > 0) & (d2 > 0)
    t = np.where(ok, (m0 - m1) / np.where(ok, d1, 1.0) / d2, 0.0)
    return np.abs(t)


def perm_pvalues(t_obs: np.ndarray, t_null: np.ndarray) -> np.ndarray:
    """Add-one permutation p per gene. ``t_null`` is [R, G]."""
    t_obs = np.asarray(t_obs, dtype=np.float64)
    t_null = np.asarray(t_null, dtype=np.float64)
    if t_null.ndim != 2 or t_null.shape[1] != t_obs.shape[0]:
        raise ValueError(f"perm_pvalues: null shape {t_null.shape} vs "
                         f"{t_obs.shape[0]} observed scores")
    ge = (t_null >= t_obs[None, :]).sum(axis=0)
    return (1.0 + ge) / (1.0 + t_null.shape[0])


def bh_fdr(pvalues: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg q-values (stable ordering, capped at 1)."""
    p = np.asarray(pvalues, dtype=np.float64)
    m = p.shape[0]
    order = np.argsort(p, kind="stable")
    ranked = p[order] * m / np.arange(1, m + 1)
    ranked = np.minimum(np.minimum.accumulate(ranked[::-1])[::-1], 1.0)
    q = np.empty(m, dtype=np.float64)
    q[order] = ranked
    return q


def selection_stats(genes: Sequence[str],
                    replicate_lists: Sequence[Sequence[str]]
                    ) -> Dict[str, np.ndarray]:
    """Per-gene selection frequency and rank dispersion across
    replicate biomarker lists (file order = rank order)."""
    n_rep = len(replicate_lists)
    if n_rep == 0:
        raise ValueError("selection_stats: no replicate lists")
    pos = {g: i for i, g in enumerate(genes)}
    n_sel = np.zeros(len(genes), dtype=np.int64)
    ranks: List[List[int]] = [[] for _ in genes]
    for rep in replicate_lists:
        seen = set()
        for rank, gene in enumerate(rep, start=1):
            if gene in seen:
                continue  # duplicate line (gene topped both L-groups)
            seen.add(gene)
            gi = pos.get(gene)
            if gi is None:
                raise ValueError(
                    f"selection_stats: replicate selected unknown gene "
                    f"{gene!r}")
            n_sel[gi] += 1
            ranks[gi].append(rank)
    mean_rank = np.full(len(genes), np.nan)
    rank_var = np.full(len(genes), np.nan)
    for gi, r in enumerate(ranks):
        if r:
            arr = np.asarray(r, dtype=np.float64)
            mean_rank[gi] = arr.mean()
            rank_var[gi] = arr.var(ddof=0)
    return {"n_sel": n_sel, "sel_freq": n_sel / float(n_rep),
            "mean_rank": mean_rank, "rank_var": rank_var}


def percentile_ci(values: Sequence[float], lo: float = 2.5,
                  hi: float = 97.5) -> Tuple[float, float]:
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        raise ValueError("percentile_ci: no values")
    return (float(np.percentile(arr, lo)), float(np.percentile(arr, hi)))


def centroid_accuracy(train_x: np.ndarray, train_y: np.ndarray,
                      test_x: np.ndarray, test_y: np.ndarray) -> float:
    """Held-out prognostic accuracy of the nearest-class-centroid rule
    over the replicate's biomarker columns. Deterministic: float64
    throughout, distance ties resolve to class 0."""
    tx = np.asarray(train_x, dtype=np.float64)
    ty = np.asarray(train_y)
    ex = np.asarray(test_x, dtype=np.float64)
    ey = np.asarray(test_y)
    if not (ty == 0).any() or not (ty == 1).any():
        raise ValueError("centroid_accuracy: training fold lost a class")
    c0 = tx[ty == 0].mean(axis=0)
    c1 = tx[ty == 1].mean(axis=0)
    d0 = ((ex - c0[None, :]) ** 2).sum(axis=1)
    d1 = ((ex - c1[None, :]) ** 2).sum(axis=1)
    pred = (d1 < d0).astype(ey.dtype)
    return float((pred == ey).mean())


def _f(x: float) -> str:
    return "%.6f" % x


def _na_f(x: float) -> str:
    return "na" if np.isnan(x) else _f(x)


def reduce_selection(genes: Sequence[str],
                     replicate_lists: Sequence[Sequence[str]]
                     ) -> Tuple[List[str], List[List[str]], Dict]:
    """Bootstrap (and CV selection-side) reduction: how often and how
    stably each gene makes the biomarker list."""
    stats = selection_stats(genes, replicate_lists)
    columns = ["sel_freq", "n_sel", "mean_rank", "rank_var"]
    rows = [[_f(stats["sel_freq"][i]), "%d" % stats["n_sel"][i],
             _na_f(stats["mean_rank"][i]), _na_f(stats["rank_var"][i])]
            for i in range(len(genes))]
    return columns, rows, {"n_replicates": len(replicate_lists)}


def reduce_permutation(genes: Sequence[str], t_obs: np.ndarray,
                       t_null: np.ndarray,
                       observed_biomarkers: Sequence[str]
                       ) -> Tuple[List[str], List[List[str]], Dict]:
    """Permutation reduction: observed |t| vs the label-shuffled null,
    with BH-FDR q-values and the observed selection as context."""
    p = perm_pvalues(t_obs, t_null)
    q = bh_fdr(p)
    selected = set(observed_biomarkers)
    columns = ["t_obs", "p_value", "q_value", "selected_obs"]
    rows = [[_f(t_obs[i]), _f(p[i]), _f(q[i]),
             "1" if genes[i] in selected else "0"]
            for i in range(len(genes))]
    return columns, rows, {"n_replicates": int(t_null.shape[0])}


def reduce_cv(genes: Sequence[str],
              fold_lists: Sequence[Sequence[str]],
              fold_accuracies: Sequence[float]
              ) -> Tuple[List[str], List[List[str]], Dict]:
    """CV reduction: selection stability across folds plus the held-out
    accuracy distribution (mean and percentile CI) in the extras."""
    columns, rows, extras = reduce_selection(genes, fold_lists)
    acc = np.asarray(fold_accuracies, dtype=np.float64)
    ci_lo, ci_hi = percentile_ci(acc)
    extras.update(acc_mean=float(acc.mean()), ci_lo=ci_lo, ci_hi=ci_hi,
                  fold_acc=[_f(a) for a in acc])
    return columns, rows, extras
