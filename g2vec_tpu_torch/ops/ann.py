"""L5 — IVF approximate-NN index over one bundle's ``[G, H]`` rows.

The port's copy of ``g2vec_tpu/ops/ann.py``, unchanged: the same
embedding bytes give the same index bytes in either package.

The exact query kernel (ops/knn.py) is O(G) per query; past ~1M genes
that arithmetic alone blows the warm-p99 budget BENCH_QUERY.json pins.
This module trades a bounded recall loss for an O(G/nlist * nprobe)
candidate scan: rows are coarse-quantized against ``nlist`` centroids
(inverted-file layout — one posting array of row ids grouped by list,
plus a ``[nlist+1]`` offsets table), a query probes the ``nprobe``
nearest lists, and the survivors are EXACT-rescored with the same
blocked cosine arithmetic as the exact path. Whenever the true top-k
rows live in the probed lists the answer is float-exact — bitwise —
to ops/knn.cosine_topk; the recall@k >= 0.95 contract at pruning
scale is pinned in tests/test_ann.py.

Deliberately HOST-SIDE numpy: the index is built once at
bundle-publication time and queried through serve/inventory.py, which
never loads torch. Centroid
refinement is therefore a numpy mirror of ops/kmeans's Lloyd step —
including its pinned empty-cluster contract (an empty cluster keeps
its previous center VERBATIM; parity with ops.kmeans._update_centers
is itself a test) — seeded either from the stage-5 k-means centroids
(free, when shapes permit) or from evenly-spaced rows.

Determinism contract (pinned): the build uses NO RNG — normalization,
evenly-spaced seeding, fixed-iteration Lloyd, and stable sorts only —
so the same embedding bytes + (nlist, seed centroids) always produce
the same index bytes, keyed like the walk cache.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from g2vec_tpu_torch.ops import knn

#: Index file set, published next to the exact arrays and sha256'd
#: into the bundle's MANIFEST.json like every other file.
ANN_FILES = ("ann_centroids.npy", "ann_postings.npy", "ann_offsets.npy")
#: Wire/disk format tag recorded in meta.json["ann"]["format"].
ANN_FORMAT = "g2vec-ivf-v1"
#: ``resolve_nlist(n, 0)`` (auto) only indexes bundles with at least
#: this many rows — below it the exact kernel is already microseconds
#: and an index would be pure publication overhead.
ANN_AUTO_MIN_ROWS = 4096
#: Default probe width when a query does not pass ``nprobe``.
DEFAULT_NPROBE = 8
#: Fixed Lloyd refinement budget — data-independent iteration count,
#: same design choice as ops/kmeans (no tolerance check).
LLOYD_ITERS = 10


def resolve_nlist(n_rows: int, ann_nlist: int = 0) -> int:
    """Effective list count for a bundle of ``n_rows`` rows.

    ``ann_nlist < 0`` disables indexing; ``> 0`` is an explicit count
    (clamped to ``n_rows`` — more lists than rows is meaningless);
    ``0`` (auto) picks ``round(sqrt(n_rows))`` — the classic IVF
    balance point where probe cost and list-scan cost match — but only
    once ``n_rows >= ANN_AUTO_MIN_ROWS``. Returns 0 for "no index".
    """
    n_rows = int(n_rows)
    ann_nlist = int(ann_nlist)
    if ann_nlist < 0 or n_rows <= 0:
        return 0
    if ann_nlist > 0:
        return min(ann_nlist, n_rows)
    if n_rows < ANN_AUTO_MIN_ROWS:
        return 0
    return min(int(round(math.sqrt(n_rows))), n_rows)


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    """Unit-normalize rows; zero-norm rows become zero vectors (they
    score -2.0 in the cosine kernel and may land in any list)."""
    x = np.asarray(x, dtype=np.float32)
    n = np.sqrt(np.einsum("ij,ij->i", x, x))
    ok = n > 0
    return np.where(ok[:, None], x / np.where(ok, n, 1)[:, None], x)


def lloyd_update(x: np.ndarray, centers: np.ndarray,
                 assign: np.ndarray) -> np.ndarray:
    """One numpy Lloyd center update, mirroring the pinned contract of
    ``ops.kmeans._update_centers``: a cluster with no members keeps its
    previous center VERBATIM (no respawn, no perturbation). Grouping is
    a stable argsort + ``np.add.reduceat`` — vectorized and
    deterministic (no float-order ambiguity: rows are summed in
    ascending row order within each cluster)."""
    nlist = centers.shape[0]
    counts = np.bincount(assign, minlength=nlist).astype(np.int64)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate(
        [np.zeros(1, dtype=np.int64), np.cumsum(counts)[:-1]])
    sums = np.zeros_like(centers, dtype=np.float64)
    nonempty = counts > 0
    if order.size:
        # reduceat needs strictly valid start offsets; rows of empty
        # clusters would alias the next cluster's first row, so reduce
        # over non-empty clusters only and scatter back.
        red = np.add.reduceat(x[order].astype(np.float64),
                              starts[nonempty], axis=0)
        sums[nonempty] = red
    out = centers.astype(np.float64, copy=True)
    out[nonempty] = sums[nonempty] / counts[nonempty, None]
    return out.astype(np.float32)


def _assign(xb: np.ndarray, centers: np.ndarray,
            block_rows: int = 65536) -> np.ndarray:
    """Nearest-center assignment under squared euclidean in the
    normalized space, blocked so a memory-mapped ``[G, H]`` table
    never materializes at once. ``||x-c||^2 = ||x||^2 + ||c||^2 -
    2 x.c`` and ``||x||^2`` is constant per row, so the argmin is over
    ``||c||^2 - 2 x.c``; argmin ties resolve to the lowest list index
    (numpy's contract), same as the jax path."""
    g = xb.shape[0]
    c2 = np.einsum("ij,ij->i", centers, centers)
    out = np.empty(g, dtype=np.int64)
    for lo in range(0, g, block_rows):
        hi = min(g, lo + block_rows)
        dots = xb[lo:hi] @ centers.T
        out[lo:hi] = np.argmin(c2[None, :] - 2.0 * dots, axis=1)
    return out


def build_ivf(embeddings: np.ndarray, nlist: int,
              seed_centroids: Optional[np.ndarray] = None,
              iters: int = LLOYD_ITERS
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the index: ``(centroids f32 [nlist, H], postings i32 [G],
    offsets i64 [nlist+1])``.

    Clustering runs in row-normalized space (cosine retrieval), seeded
    from the stage-5 k-means ``seed_centroids`` when their trailing dim
    matches ``H`` (normalized, first ``nlist`` rows), topped up with
    evenly-spaced normalized embedding rows; then ``iters`` fixed Lloyd
    updates. Deterministic end to end — no RNG anywhere.
    """
    embeddings = np.asarray(embeddings)
    if embeddings.ndim != 2 or embeddings.shape[0] < 1:
        raise ValueError(f"build_ivf needs a non-empty [G, H] matrix, "
                         f"got shape {embeddings.shape}")
    g, h = embeddings.shape
    nlist = int(nlist)
    if not (1 <= nlist <= g):
        raise ValueError(f"build_ivf needs 1 <= nlist <= {g}, "
                         f"got {nlist}")
    xb = _normalize_rows(embeddings)
    seeds = []
    if seed_centroids is not None:
        sc = np.asarray(seed_centroids, dtype=np.float32)
        if sc.ndim == 2 and sc.shape[1] == h and sc.shape[0] >= 1:
            seeds.append(_normalize_rows(sc)[:nlist])
    have = seeds[0].shape[0] if seeds else 0
    nfill = nlist - have
    if nfill > 0:
        fill_idx = (np.arange(nfill, dtype=np.int64) * g) // nfill
        seeds.append(xb[fill_idx])
    centers = np.concatenate(seeds, axis=0) if len(seeds) > 1 \
        else seeds[0]
    for _ in range(int(iters)):
        centers = lloyd_update(xb, centers, _assign(xb, centers))
    assign = _assign(xb, centers)
    counts = np.bincount(assign, minlength=nlist).astype(np.int64)
    # Stable argsort: postings are ascending row id WITHIN each list —
    # the order cosine_topk_subset's tie rule depends on.
    postings = np.argsort(assign, kind="stable").astype(np.int32)
    offsets = np.concatenate(
        [np.zeros(1, dtype=np.int64), np.cumsum(counts)])
    return centers.astype(np.float32), postings, offsets


class IVFIndex:
    """One mapped index: centroids + postings + offsets, with shape
    sanity enforced at construction so a structurally-broken index is
    refused before it can ever mis-answer a query."""

    def __init__(self, centroids: np.ndarray, postings: np.ndarray,
                 offsets: np.ndarray, n_rows: int, hidden: int,
                 pvecs: Optional[np.ndarray] = None):
        centroids = np.asarray(centroids)
        postings = np.asarray(postings)
        offsets = np.asarray(offsets)
        if centroids.ndim != 2 or centroids.shape[1] != int(hidden) \
                or centroids.shape[0] < 1:
            raise ValueError(f"ann centroids {centroids.shape} vs "
                             f"hidden={hidden}")
        nlist = centroids.shape[0]
        if offsets.ndim != 1 or offsets.shape[0] != nlist + 1:
            raise ValueError(f"ann offsets {offsets.shape} vs "
                             f"nlist={nlist}")
        if postings.ndim != 1 or postings.shape[0] != int(n_rows):
            raise ValueError(f"ann postings {postings.shape} vs "
                             f"G={n_rows}")
        off = offsets.astype(np.int64)
        if off[0] != 0 or off[-1] != int(n_rows) or \
                np.any(np.diff(off) < 0):
            raise ValueError("ann offsets not a monotone [0..G] table")
        if postings.shape[0] and (postings.min() < 0
                                  or postings.max() >= int(n_rows)):
            raise ValueError("ann postings reference rows outside "
                             f"[0, {n_rows})")
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.postings = postings
        self.offsets = off
        self.nlist = nlist
        self.n_rows = int(n_rows)
        if pvecs is not None:
            pvecs = np.asarray(pvecs)
            if pvecs.ndim != 2 or pvecs.shape[0] != int(n_rows) \
                    or pvecs.shape[1] != int(hidden):
                raise ValueError(f"ann posting-major vectors "
                                 f"{pvecs.shape} vs [{n_rows}, {hidden}]")
        self.pvecs = pvecs

    def probe_lists(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """Ascending-sorted ids of the ``nprobe`` nearest lists —
        nearest under the SAME metric the build assigned rows with
        (squared euclidean against the normalized query), so a row
        always probes its own list first when the query sits on it."""
        nprobe = min(max(int(nprobe), 1), self.nlist)
        q = np.asarray(q, dtype=np.float32).reshape(-1)
        qn = np.sqrt(np.dot(q, q))
        if qn > 0:
            q = q / qn
        c2 = np.einsum("ij,ij->i", self.centroids, self.centroids)
        scores = c2 - 2.0 * (self.centroids @ q)
        if nprobe < self.nlist:
            lists = np.argpartition(scores, nprobe - 1)[:nprobe]
        else:
            lists = np.arange(self.nlist)
        return np.sort(lists)

    def probe(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """Sorted (ascending, duplicate-free) candidate row ids from
        the ``nprobe`` nearest lists (:meth:`probe_lists`)."""
        parts = [np.asarray(
            self.postings[self.offsets[li]:self.offsets[li + 1]])
            for li in self.probe_lists(q, nprobe)]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(parts).astype(np.int64))


def posting_major_topk(norms: np.ndarray, index: IVFIndex, q: np.ndarray,
                       k: int, nprobe: int = DEFAULT_NPROBE,
                       exclude: int = -1, block_rows: int = 8192
                       ) -> "Tuple[np.ndarray, np.ndarray, int]":
    """The streaming twin of probe + :func:`knn.cosine_topk_subset`:
    candidate vectors come from the index's posting-major copy
    (``index.pvecs``), so each probed list is ONE contiguous slab read
    instead of a per-row fancy-indexed gather over the ``[G, H]`` map.

    Bitwise-equality contract (pinned by tests/test_ann.py): slab
    reads only assemble the candidate ARENA — the dots themselves run
    over the arena reordered to ascending global row id, in the SAME
    ``block_rows`` blocks as :func:`knn.cosine_topk_subset`, followed
    by the same ``np.where`` zero-norm guard against ``norms[row] *
    qn``, the same ``-inf`` exclude, and the same ``_topk_desc``
    select. Matching the GEMV block shapes is load-bearing, not
    cosmetic: BLAS dispatches different accumulation kernels by
    operand shape, so the same float32 row dotted inside a 39-row
    slab and inside an 8192-row block can differ in the last ulp.
    Scoring per-list slabs directly would therefore break bitwise
    equality at scale even though every row value is byte-identical.
    """
    lists = index.probe_lists(q, nprobe)
    q32 = np.asarray(q, dtype=np.float32).reshape(-1)
    qn = np.sqrt(np.dot(q32, q32))
    id_parts, vec_parts = [], []
    for li in lists:
        o0, o1 = index.offsets[li], index.offsets[li + 1]
        if o1 <= o0:
            continue
        id_parts.append(np.asarray(index.postings[o0:o1],
                                   dtype=np.int64))
        vec_parts.append(np.asarray(index.pvecs[o0:o1],
                                    dtype=np.float32))
    if not id_parts:
        return (np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.float32), 0)
    ids = np.concatenate(id_parts)
    # Rows live in exactly one list, so ids are unique; sorting them
    # ascending makes position order == global row id order, the
    # precondition for _topk_desc's tie rule matching the exact path.
    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    vecs = np.concatenate(vec_parts)[order]
    m = ids.shape[0]
    sims = np.empty(m, dtype=np.float32)
    for lo in range(0, m, block_rows):
        hi = min(m, lo + block_rows)
        sims[lo:hi] = vecs[lo:hi] @ q32
    denom = np.asarray(norms, dtype=np.float32)[ids] * qn
    ok = denom > 0
    sims = np.where(ok, sims / np.where(ok, denom, 1), np.float32(-2.0))
    if 0 <= exclude < index.n_rows:
        pos = np.searchsorted(ids, exclude)
        if pos < ids.shape[0] and ids[pos] == exclude:
            sims[pos] = -np.inf
    loc = knn._topk_desc(sims, k)
    return ids[loc], sims[loc], int(ids.size)


def ivf_topk(emb: np.ndarray, norms: np.ndarray, index: IVFIndex,
             q: np.ndarray, k: int, nprobe: int = DEFAULT_NPROBE,
             exclude: int = -1, block_rows: int = 8192,
             posting_major: Optional[bool] = None
             ) -> "Tuple[np.ndarray, np.ndarray, int]":
    """Approximate cosine top-k: probe, then exact-rescore survivors.

    Returns ``(idx, sims, n_candidates)``. When the probe covers every
    row (``nprobe >= nlist``, or every populated list probed) the call
    delegates to :func:`ops.knn.cosine_topk` outright, so the
    degenerate case is STRUCTURALLY bitwise-equal to the exact path,
    not merely numerically close.

    ``posting_major`` selects the candidate storage: ``None`` (auto)
    streams the contiguous posting-ordered copy whenever the index
    carries one (:func:`posting_major_topk` — bitwise-equal answers),
    ``False`` forces the row-gather path (the bench A/B control),
    ``True`` requires the copy and raises without it.
    """
    g = emb.shape[0]
    use_pm = (index.pvecs is not None) if posting_major is None \
        else bool(posting_major)
    if use_pm and index.pvecs is None:
        raise ValueError("posting_major=True but the index carries no "
                         "posting-major vector copy")
    if use_pm:
        nprobe_eff = min(max(int(nprobe), 1), index.nlist)
        if nprobe_eff >= index.nlist:
            idx, sims = knn.cosine_topk(emb, norms, q, k,
                                        exclude=exclude,
                                        block_rows=block_rows)
            return idx, sims, g
        return posting_major_topk(norms, index, q, k, nprobe=nprobe,
                                  exclude=exclude, block_rows=block_rows)
    cand = index.probe(q, nprobe)
    if cand.size >= g:
        idx, sims = knn.cosine_topk(emb, norms, q, k, exclude=exclude,
                                    block_rows=block_rows)
        return idx, sims, g
    if cand.size == 0:
        return (np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.float32), 0)
    idx, sims = knn.cosine_topk_subset(emb, norms, cand, q, k,
                                       exclude=exclude,
                                       block_rows=block_rows)
    return idx, sims, int(cand.size)
