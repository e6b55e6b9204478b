"""L3 — per-group edge weights from Pearson correlations, on the device.

Reference semantics (construct_adjMat, G2Vec.py:370-391; compute_PCC,
G2Vec.py:354-368): for a patient group, each directed edge (src, dst) of
the network gets weight |PCC(expr[:, src], expr[:, dst])| over that
group's samples only, kept iff strictly greater than the threshold (0.5).
A degenerate gene (constant over the group) gets PCC 0 against everything
(ref: G2Vec.py:359-363). The arithmetic is ``g2vec_tpu/ops/graph.py``'s:
z-score each gene column once in float32, then PCC = the population mean
of the endpoint z-products, one vectorized pass over all edges.
"""
from __future__ import annotations

import numpy as np
import torch

from g2vec_tpu_torch.device import resolve_device


def _zscore_columns(expr: torch.Tensor) -> torch.Tensor:
    """Per-gene z-score over samples (population std, ddof=0);
    degenerate columns -> all-zero.

    The degeneracy test is max==min (exact in float32), not std==0: the
    float32 std of a constant column can come out as a tiny nonzero value.
    """
    mean = expr.mean(dim=0, keepdim=True)
    centered = expr - mean
    std = torch.sqrt((centered * centered).mean(dim=0, keepdim=True))
    constant = expr.amax(dim=0, keepdim=True) == expr.amin(dim=0, keepdim=True)
    ok = ~constant & (std > 0.0)
    return torch.where(ok, centered / torch.where(ok, std, 1.0), 0.0)


def edge_weights(expr_group, src: np.ndarray, dst: np.ndarray, *,
                 device="cuda") -> torch.Tensor:
    """|PCC| per directed edge over one group's samples -> [E] float32 on
    ``device``. ``expr_group``: [S, G] (samples of ONE prognosis group);
    ``src``/``dst``: [E] int edge endpoint indices."""
    dev = resolve_device(device)
    z = _zscore_columns(torch.as_tensor(
        np.asarray(expr_group, dtype=np.float32), device=dev))
    zt = z.T
    zs = zt[torch.as_tensor(np.asarray(src, dtype=np.int64), device=dev)]
    zd = zt[torch.as_tensor(np.asarray(dst, dtype=np.int64), device=dev)]
    return torch.abs(torch.mean(zs * zd, dim=1))


def thresholded_edges(expr_group, src: np.ndarray, dst: np.ndarray,
                      threshold: float = 0.5, *, device="cuda"):
    """Surviving (src, dst, |PCC|) triples as host numpy arrays.

    |PCC| strictly > threshold (ref: G2Vec.py:389-390), directed. Duplicate
    (src, dst) pairs collapse to their first occurrence (the reference's
    dense write is idempotent, so this is the same graph).
    """
    w = edge_weights(expr_group, src, dst, device=device).cpu().numpy()
    keep = w > threshold
    src_k, dst_k, w_k = src[keep], dst[keep], w[keep]
    _, first = np.unique(
        src_k.astype(np.int64) * (np.max(dst_k, initial=0) + 1) + dst_k,
        return_index=True)
    first.sort()
    return src_k[first], dst_k[first], w_k[first]
