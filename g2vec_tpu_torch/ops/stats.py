"""L5 statistics ops, vectorized over the gene axis on the device.

The reference computes these one gene at a time in Python loops
(compute_tscores, G2Vec.py:151-157; compute_tstatistics, G2Vec.py:138-149;
transform_minmax, G2Vec.py:133-136); the arithmetic here is
``g2vec_tpu/ops/stats.py``'s.
"""
from __future__ import annotations

import torch


def tscores(expr_good: torch.Tensor, expr_poor: torch.Tensor) -> torch.Tensor:
    """|pooled-variance two-sample t| per gene (ref: G2Vec.py:138-157).

    Sample std with ddof=1 (G2Vec.py:140); pooled denominator
    sqrt(((n0-1)s0^2 + (n1-1)s1^2) / (n0+n1-2)) times sqrt(1/n0 + 1/n1)
    (G2Vec.py:143-144); 0.0 whenever either denominator is not strictly
    positive (G2Vec.py:145-148).
    """
    n0 = expr_good.shape[0]
    n1 = expr_poor.shape[0]
    m0 = expr_good.mean(dim=0)
    m1 = expr_poor.mean(dim=0)
    s0 = expr_good.std(dim=0, correction=1)
    s1 = expr_poor.std(dim=0, correction=1)
    pooled = ((n0 - 1.0) * s0 * s0 + (n1 - 1.0) * s1 * s1) / (n0 + n1 - 2.0)
    d1 = torch.sqrt(pooled)
    d2 = torch.sqrt(torch.tensor(1.0 / n0 + 1.0 / n1, dtype=torch.float32,
                               device=expr_good.device))
    ok = (d1 > 0.0) & (d2 > 0.0)
    t = torch.where(ok, (m0 - m1) / torch.where(ok, d1, 1.0) / d2, 0.0)
    return torch.abs(t)


def _rescale(scores, old_min, old_max, new_min, new_max):
    span = old_max - old_min
    safe = torch.where(span > 0.0, span, 1.0)
    return torch.where(span > 0.0,
                       (new_max - new_min) / safe * (scores - old_min) + new_min,
                       torch.full_like(scores, new_min))


def minmax(scores: torch.Tensor, new_min: float = 0.0,
           new_max: float = 1.0) -> torch.Tensor:
    """Linear rescale to [new_min, new_max] (ref: G2Vec.py:133-136); a
    constant vector maps to all-new_min instead of dividing by zero."""
    return _rescale(scores, scores.min(), scores.max(), new_min, new_max)


def masked_minmax(scores: torch.Tensor, mask: torch.Tensor,
                  new_min: float = 0.0, new_max: float = 1.0) -> torch.Tensor:
    """:func:`minmax` over the ``mask``-selected subset without gathering:
    masked positions carry exactly the values the gathered call would;
    unmasked positions are rescaled values the caller never reads."""
    return masked_rescale(scores, *masked_extrema(scores, mask),
                          new_min, new_max)


def masked_extrema(scores: torch.Tensor, mask: torch.Tensor):
    """(min, max) over the masked subset: +inf/-inf for an empty mask, the
    identities of a cross-rank min/max reduction."""
    return (torch.min(torch.where(mask, scores, torch.inf)),
            torch.max(torch.where(mask, scores, -torch.inf)))


def masked_rescale(scores: torch.Tensor, old_min, old_max,
                   new_min: float = 0.0, new_max: float = 1.0
                   ) -> torch.Tensor:
    """:func:`masked_minmax`'s rescale half with the extrema given: with
    the globally reduced extrema the masked positions of a rank's slice
    carry exactly the values of the unsplit call."""
    return _rescale(scores, old_min, old_max, new_min, new_max)


def dscores(embeddings: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 norm of embedding rows (ref: G2Vec.py:96)."""
    return torch.sqrt(torch.sum(embeddings * embeddings, dim=1))
