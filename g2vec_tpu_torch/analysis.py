"""L5 — L-group assignment and biomarker selection.

``find_lgroups`` reimplements ref G2Vec.py:167-200 as
``g2vec_tpu/analysis.py`` does:

1. k-means (k=3) over the gene embeddings, on the device;
2. the LARGEST cluster is "other/init" (index 2) — the blob of genes that
   never appeared in a path and barely moved from init;
3. the remaining two clusters are voted good vs poor by how many member
   genes the path-frequency majority marked good (freq 0) vs poor (freq 1);
4. renumber to {0: good, 1: poor, 2: other}.

The reference's step-3 vote is neutered by a list-vs-int comparison bug
(ref: G2Vec.py:186-187); it is reproduced under ``compat_tiebreak=True``.

The ``*_lanes`` functions are stages 5-6 over the batch engine's
``[B, G, H]`` lane stack (``g2vec_tpu/analysis.py``'s vmapped variants).
The contract is that every lane's files are its solo run's, so each lane
runs the solo function on its own embeddings with its own k-means
generator; only the lane-invariant t-scores are computed once for the
lanes that share a cohort.

The ``*_sharded`` functions are stages 5-6 over a gene-range-split
embedding (``g2vec_tpu/analysis.py:290-360``): each rank holds its
``[g_local, H]`` slice, and only per-cluster statistics, vote tallies and
masked extrema cross ranks.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from g2vec_tpu_torch.ops.kmeans import kmeans, kmeans_sharded
from g2vec_tpu_torch.ops.stats import (dscores, masked_extrema, masked_minmax,
                                       masked_rescale, tscores)


def freq_index(genes: Sequence[str], gene_freq: Dict[str, int]) -> np.ndarray:
    """``gene_freq`` dict -> the dense [G] int32 vote vector (absent genes
    default to 2 / "other", ref: G2Vec.py:172)."""
    return np.array([gene_freq.get(g, 2) for g in genes], dtype=np.int32)


def _vote_counts(km_idx: torch.Tensor, freq_idx: torch.Tensor, k: int):
    """Per-cluster [k] tallies: members, good-majority members,
    poor-majority members — the only values that cross to the host."""
    counts = torch.bincount(km_idx, minlength=k)
    good = torch.bincount(km_idx[freq_idx == 0], minlength=k)
    poor = torch.bincount(km_idx[freq_idx == 1], minlength=k)
    return counts.cpu().numpy(), good.cpu().numpy(), poor.cpu().numpy()


def _pick_clusters(counts: np.ndarray, good_counts: np.ndarray,
                   poor_counts: np.ndarray, k: int,
                   compat_tiebreak: bool) -> Tuple[int, int]:
    """The good/poor cluster vote on host ints.

    Largest cluster = "other/init"; ties -> lowest cluster index, matching
    the reference's strict-> scan (G2Vec.py:174-180).
    """
    largest = int(np.argmax(counts))
    remaining = [i for i in range(k) if i != largest]
    if compat_tiebreak:
        # Reference bug: the vote always reads 0-0, and the strict '>' sends
        # it down the else branch: good = second remaining, poor = first
        # (ref: G2Vec.py:189-194).
        return remaining[1], remaining[0]
    gp_diff = {i: int(good_counts[i]) - int(poor_counts[i])
               for i in remaining}
    good_cluster = max(remaining, key=lambda i: (gp_diff[i], i))
    poor_cluster = min((i for i in remaining if i != good_cluster),
                       key=lambda i: (gp_diff[i], -i))
    return good_cluster, poor_cluster


def _renumber(km_idx: torch.Tensor, good: int, poor: int) -> torch.Tensor:
    """Cluster labels -> {0: good, 1: poor, 2: other} (extra clusters of
    k > 3 fall to 2)."""
    return torch.where(km_idx == good, 0,
                       torch.where(km_idx == poor, 1, 2)).to(torch.int32)


def find_lgroups(embeddings: torch.Tensor, freq_idx: np.ndarray, *,
                 generator: torch.Generator, k: int = 3,
                 compat_tiebreak: bool = False, n_init: int = 10,
                 iters: int = 50, centers0=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L-groups [G] int32 and the winning k-means centres [k, d], both on
    the embeddings' device. ``centers0 [n_init, k, d]`` replaces the
    k-means++ draws (tests)."""
    if k < 3:
        raise ValueError(f"find_lgroups needs k >= 3 (good/poor/other), got {k}")
    km_idx, centers, _ = kmeans(embeddings, k, generator=generator,
                                n_init=n_init, iters=iters, centers0=centers0)
    counts, good, poor = _vote_counts(
        km_idx, torch.as_tensor(freq_idx, device=km_idx.device), k)
    good_cluster, poor_cluster = _pick_clusters(counts, good, poor, k,
                                                compat_tiebreak)
    return _renumber(km_idx, good_cluster, poor_cluster), centers


def _vote_counts_lanes(km_stack: torch.Tensor, freq_stack: np.ndarray,
                       k: int):
    """Per-lane vote tallies: [B, k] stacks of :func:`_vote_counts`."""
    per_lane = [_vote_counts(km, torch.as_tensor(freq, device=km.device), k)
                for km, freq in zip(km_stack, freq_stack)]
    return tuple(np.stack(t) for t in zip(*per_lane))


def find_lgroups_lanes(emb_stack: torch.Tensor, freq_stack: np.ndarray,
                       kmeans_seeds: Sequence[int], *, k: int = 3,
                       compat_tiebreak: bool = False, n_init: int = 10,
                       iters: int = 50, centers0=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 5 over the lane stack ``emb_stack [B, G, H]``: L-groups
    [B, G] int32 and winning centres [B, k, H], each lane's the solo
    :func:`find_lgroups` of its embeddings under a generator seeded with
    its ``kmeans_seeds`` entry. ``centers0 [B, n_init, k, H]`` replaces
    the k-means++ draws (tests)."""
    if len(kmeans_seeds) != emb_stack.shape[0] \
            or len(freq_stack) != emb_stack.shape[0]:
        raise ValueError(f"{emb_stack.shape[0]} lanes, "
                         f"{len(kmeans_seeds)} k-means seeds, "
                         f"{len(freq_stack)} vote vectors")
    groups, centers = [], []
    for b, seed in enumerate(kmeans_seeds):
        # A fresh contiguous copy: the solo run's embeddings are one.
        lg, c = find_lgroups(
            emb_stack[b].clone(), freq_stack[b],
            generator=torch.Generator().manual_seed(int(seed)), k=k,
            compat_tiebreak=compat_tiebreak, n_init=n_init, iters=iters,
            centers0=None if centers0 is None else centers0[b])
        groups.append(lg)
        centers.append(c)
    return torch.stack(groups), torch.stack(centers)


def biomarker_scores(embeddings: torch.Tensor, expr_good: torch.Tensor,
                     expr_poor: torch.Tensor, lgroup_idx: torch.Tensor,
                     score_mix: float = 0.5) -> torch.Tensor:
    """Mixed d/t gene scores for both L-groups: a [2, G] stack over the
    full gene axis (row 0 good, row 1 poor), each row min-max rescaled over
    its own L-group's genes; positions outside a row's group are never
    read."""
    return _mixed_scores(dscores(embeddings), tscores(expr_good, expr_poor),
                         lgroup_idx, score_mix)


def biomarker_scores_lanes(emb_stack: torch.Tensor, expr_good: torch.Tensor,
                           expr_poor: torch.Tensor,
                           lgroup_stack: torch.Tensor,
                           score_mix: float = 0.5) -> torch.Tensor:
    """:func:`biomarker_scores` for lanes that share one cohort and label
    view: [B, 2, G]. The t-scores are computed once; each lane's d-scores
    and rescaling are the solo ops on its own embeddings."""
    t_full = tscores(expr_good, expr_poor)
    return torch.stack([
        _mixed_scores(dscores(emb_stack[b].clone()), t_full, lgroup_stack[b],
                      score_mix) for b in range(emb_stack.shape[0])])


def _mixed_scores(d_full: torch.Tensor, t_full: torch.Tensor,
                  lgroup_idx: torch.Tensor, score_mix: float) -> torch.Tensor:
    rows = []
    for group in (0, 1):
        mask = lgroup_idx == group
        d = masked_minmax(d_full, mask)
        t = masked_minmax(t_full, mask)
        rows.append(score_mix * d + (1.0 - score_mix) * t)
    return torch.stack(rows)


def top_biomarkers(scores2: np.ndarray, lgroup_idx: np.ndarray,
                   genes: np.ndarray, num_biomarker: int
                   ) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Top-N symbols per L-group from the [2, G] score stack (ref sort
    semantics: G2Vec.py:104-109): sort descending (stable, so ties keep
    gene order), take the top N, sort those alphabetically; the final list
    is both groups' picks sorted again."""
    biomarkers: List[str] = []
    detail: Dict[str, np.ndarray] = {}
    for group in (0, 1):
        mask = lgroup_idx == group
        group_genes = genes[mask]
        if group_genes.size == 0:
            continue
        scores = scores2[group][mask]
        order = np.argsort(-scores, kind="stable")
        top = sorted(group_genes[order[:num_biomarker]].tolist())
        biomarkers += top
        detail["good" if group == 0 else "poor"] = scores
    return sorted(biomarkers), detail



def find_lgroups_sharded(emb_local: torch.Tensor, freq_idx_local: np.ndarray,
                         sctx, *, generator: torch.Generator, k: int = 3,
                         compat_tiebreak: bool = False, n_init: int = 10,
                         iters: int = 50, centers0=None) -> torch.Tensor:
    """:func:`find_lgroups` over a gene-range-split embedding:
    ``emb_local`` is this rank's ``[g_local, H]`` slice, ``freq_idx_local``
    the same slice of the [G] vote vector and ``sctx`` a
    :class:`~g2vec_tpu_torch.parallel.shard.ShardContext`. Returns the
    local [g_local] L-groups (the writers gather them). The vote reduces
    one [3, k] tally stack and then runs :func:`find_lgroups`'s host
    arithmetic, so the decision is the same on every rank. One rank uses
    :func:`find_lgroups` instead (byte identity)."""
    if k < 3:
        raise ValueError(f"find_lgroups needs k >= 3 (good/poor/other), got {k}")
    km_idx, _, _ = kmeans_sharded(
        emb_local, k, generator=generator, allreduce=sctx.allreduce,
        gather=sctx.gather_concat, n_init=n_init, iters=iters,
        centers0=centers0)
    counts, good, poor = _vote_counts(
        km_idx, torch.as_tensor(freq_idx_local, device=km_idx.device), k)
    tallies = sctx.allreduce("lg_vote", np.stack([counts, good, poor]))
    good_cluster, poor_cluster = _pick_clusters(
        tallies[0], tallies[1], tallies[2], k, compat_tiebreak)
    return _renumber(km_idx, good_cluster, poor_cluster)


def biomarker_scores_sharded(emb_local: torch.Tensor,
                             expr_good_local: torch.Tensor,
                             expr_poor_local: torch.Tensor,
                             lgroup_local: torch.Tensor, sctx,
                             score_mix: float = 0.5) -> torch.Tensor:
    """:func:`biomarker_scores` over the rank's gene range: a local
    [2, g_local] score stack. d-scores are row-local and t-scores
    column-local (``expr_*_local`` are the expression matrices' local gene
    columns), so both are exact on slices; each group's masked extrema are
    reduced across ranks (min and max do not depend on order, so they are
    the unsplit call's bits) and fed to the rescale. The masked positions
    of the concatenated slices are the unsplit [2, G] values."""
    d_local = dscores(emb_local)
    t_local = tscores(expr_good_local, expr_poor_local)
    rows = []
    for group in (0, 1):
        mask = lgroup_local == group
        parts = []
        for name, s in (("d", d_local), ("t", t_local)):
            lo, hi = masked_extrema(s, mask)
            ext = np.array([float(lo), -float(hi)])
            ext = sctx.allreduce(f"bm_ext/{group}/{name}", ext, op="min")
            parts.append(masked_rescale(
                s, torch.tensor(ext[0], dtype=torch.float32, device=s.device),
                torch.tensor(-ext[1], dtype=torch.float32, device=s.device)))
        rows.append(score_mix * parts[0] + (1.0 - score_mix) * parts[1])
    return torch.stack(rows)
