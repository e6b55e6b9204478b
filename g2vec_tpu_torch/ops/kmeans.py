"""L5 — k-means (k-means++ seeding + fixed-iteration Lloyd, multi-restart).

The algorithm of ``g2vec_tpu/ops/kmeans.py`` (which stands in for the
reference's ``sklearn.cluster.KMeans(n_clusters=3, random_state=0)``,
ref: G2Vec.py:169): ``n_init`` k-means++ restarts drawn from one
``torch.Generator``, a fixed number of Lloyd iterations with all restarts
batched as one leading dimension, empty clusters keep their centre
verbatim, ``argmin`` ties go to the lowest index, and the restart with the
lowest inertia wins (the first on a tie).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _pairwise_sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[..., N, k] squared Euclidean distances of ``x [N, d]`` to
    ``centers [..., k, d]`` (one matmul per restart)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)                  # [N, 1]
    c2 = torch.sum(centers * centers, dim=-1).unsqueeze(-2)     # [..., 1, k]
    xc = x @ centers.transpose(-1, -2)                          # [..., N, k]
    return torch.clamp(x2 - 2.0 * xc + c2, min=0.0)


def _kmeanspp_init(x: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: first centre uniform, the rest ~ D^2 weighting
    (a Gumbel-max draw proportional to D^2). The draws come from a CPU
    generator and move to ``x``'s device, so one seed seeds the same
    centres on every device."""
    n = x.shape[0]
    first = int(torch.randint(n, (1,), generator=generator))
    centers = x[first].repeat(k, 1)
    d2 = torch.sum((x - x[first]) ** 2, dim=1)
    for j in range(1, k):
        pos = d2 > 0
        logits = torch.where(pos, torch.log(torch.where(pos, d2, 1.0)),
                             -torch.inf)
        gumbel = -torch.log(torch.empty(n).exponential_(
            generator=generator)).to(x.device)
        idx = int(torch.argmax(logits + gumbel)) if bool(pos.any()) else 0
        centers[j] = x[idx]
        d2 = torch.minimum(d2, torch.sum((x - x[idx]) ** 2, dim=1))
    return centers


def _lloyd(x: torch.Tensor, centers0: torch.Tensor, iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration Lloyd over ``centers0 [..., k, d]`` (any leading
    restart dims); returns (centers, inertia [...])."""
    k = centers0.shape[-2]
    centers = centers0
    for _ in range(iters):
        assign = torch.argmin(_pairwise_sq_dists(x, centers), dim=-1)
        onehot = F.one_hot(assign, k).to(x.dtype)               # [..., N, k]
        counts = onehot.sum(dim=-2)                             # [..., k]
        sums = onehot.transpose(-1, -2) @ x                     # [..., k, d]
        # An empty cluster keeps its centre verbatim (no respawn).
        centers = torch.where(counts.unsqueeze(-1) > 0,
                              sums / torch.clamp(counts, min=1.0).unsqueeze(-1),
                              centers)
    inertia = torch.sum(torch.amin(_pairwise_sq_dists(x, centers), dim=-1),
                        dim=-1)
    return centers, inertia


def kmeans(x: torch.Tensor, k: int, *, generator: torch.Generator,
           n_init: int = 10, iters: int = 50,
           centers0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-restart k-means on ``x``'s device. Returns (labels [N] int64,
    centers [k, d], inertia).

    ``centers0 [n_init, k, d]`` replaces the k-means++ draws (the tests
    hand both packages the same starting centres); ``generator`` is a CPU
    generator whatever ``x``'s device.
    """
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(
            f"kmeans needs a non-empty [N, d] matrix, got shape {tuple(x.shape)}")
    if k < 1:
        raise ValueError(f"kmeans needs k >= 1, got {k}")
    x = x.float()
    if centers0 is None:
        centers0 = torch.stack([_kmeanspp_init(x, k, generator)
                                for _ in range(n_init)])
    else:
        centers0 = torch.as_tensor(centers0, dtype=torch.float32,
                                   device=x.device)
        if centers0.dim() != 3 or centers0.shape[1:] != (k, x.shape[1]):
            raise ValueError(f"centers0 must be [n_init, {k}, {x.shape[1]}], "
                             f"got {tuple(centers0.shape)}")
    centers, inertia = _lloyd(x, centers0, iters)
    best = int(torch.argmin(inertia))
    labels = torch.argmin(_pairwise_sq_dists(x, centers[best]), dim=1)
    return labels, centers[best], inertia[best]


# ---------------------------------------------------------------------------
# Row-sharded k-means: each rank holds [N_local, d] of the matrix.
# ---------------------------------------------------------------------------

#: Rows each rank gives the k-means++ seeding sample. Seeding must see the
#: global geometry (a contiguous gene range is a biased slice of it), and
#: 4096 evenly spaced rows a rank keep the gathered sample small at any N.
SEED_SAMPLE_PER_RANK = 4096


def _local_lloyd_stats(x: torch.Tensor, centers: torch.Tensor, k: int):
    """One rank's Lloyd sufficient statistics: per-cluster counts [k], sums
    [k, d] and the local inertia, the only values that cross ranks."""
    d2 = _pairwise_sq_dists(x, centers)
    onehot = F.one_hot(torch.argmin(d2, dim=1), k).to(x.dtype)
    return onehot.sum(dim=0), onehot.T @ x, torch.sum(torch.amin(d2, dim=1))


def kmeans_sharded(x_local: torch.Tensor, k: int, *,
                   generator: torch.Generator, allreduce, gather,
                   n_init: int = 10, iters: int = 50,
                   centers0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Lloyd over a row-sharded matrix: ``x_local`` is this rank's
    disjoint ``[N_local, d]`` slice, and only per-cluster statistics cross
    ranks. Returns ``(labels_local [N_local], centers [k, d], inertia)``;
    the centres and the inertia are the same on every rank.

    The collectives come in as callables, as in ``g2vec_tpu/ops/kmeans.py``:
    ``allreduce(name, array) -> array`` sums same-shape host arrays in rank
    order and ``gather(name, array) -> array`` concatenates per-rank arrays
    in rank order on every rank (a
    :class:`~g2vec_tpu_torch.parallel.shard.ShardContext`'s ``allreduce``
    and ``gather_concat``).

    The recipe of :func:`kmeans`: ``n_init`` k-means++ restarts drawn from
    ``generator`` on one gathered sample of evenly spaced rows
    (:data:`SEED_SAMPLE_PER_RANK` a rank), so every rank seeds the same
    centres; ``iters`` Lloyd steps a restart, each one allreduce of the
    ``[k, d + 1]`` sums and counts; empty clusters keep their centre; the
    lowest inertia wins. ``centers0 [n_init, k, d]`` replaces the draws
    (tests). At one rank callers use :func:`kmeans` (byte identity); at
    more the sums add in another order, so it is not its bits.
    """
    import numpy as np

    if k < 1:
        raise ValueError(f"kmeans needs k >= 1, got {k}")
    if x_local.dim() != 2 or x_local.shape[0] < 1:
        raise ValueError(f"kmeans_sharded needs a non-empty [N_local, d] "
                         f"matrix, got shape {tuple(x_local.shape)}")
    x_local = x_local.float()
    dev = x_local.device
    if centers0 is None:
        n_local = x_local.shape[0]
        take = min(n_local, SEED_SAMPLE_PER_RANK)
        idx = np.unique((np.arange(take, dtype=np.int64) * n_local) // take)
        sample = torch.from_numpy(gather(
            "km_seed_sample", x_local[torch.from_numpy(idx).to(dev)]
            .cpu().numpy())).to(dev)
        centers0 = [_kmeanspp_init(sample, k, generator)
                    for _ in range(n_init)]
    else:
        centers0 = torch.as_tensor(centers0, dtype=torch.float32, device=dev)
        if centers0.dim() != 3 or centers0.shape[1:] != (k, x_local.shape[1]):
            raise ValueError(f"centers0 must be [n_init, {k}, "
                             f"{x_local.shape[1]}], got "
                             f"{tuple(centers0.shape)}")
    best_inertia = best_centers = None
    for i, centers in enumerate(centers0):
        for _ in range(iters):
            counts, sums, _ = _local_lloyd_stats(x_local, centers, k)
            # Sums and counts ride one message a step.
            packed = allreduce(f"km_stats/{i}", torch.cat(
                [sums, counts[:, None]], dim=1).cpu().numpy())
            packed = torch.from_numpy(np.ascontiguousarray(packed)).to(dev)
            g_sums, g_counts = packed[:, :-1], packed[:, -1]
            centers = torch.where(
                g_counts[:, None] > 0,
                g_sums / torch.clamp(g_counts, min=1.0)[:, None], centers)
        _, _, local_inertia = _local_lloyd_stats(x_local, centers, k)
        inertia = float(allreduce(f"km_inertia/{i}", np.asarray(
            [float(local_inertia)], np.float32))[0])
        if best_inertia is None or inertia < best_inertia:
            best_inertia, best_centers = inertia, centers
    labels = torch.argmin(_pairwise_sq_dists(x_local, best_centers), dim=1)
    return labels, best_centers, best_inertia
