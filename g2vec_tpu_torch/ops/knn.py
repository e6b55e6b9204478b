"""L5 — blocked exact top-k kernels for the interactive query plane.

The port's copy of ``g2vec_tpu/ops/knn.py``, unchanged.

Deliberately HOST-SIDE numpy, not a device kernel: the query plane
(serve/inventory.py) memory-maps float32 ``[G, H]`` embedding bundles
and promises O(block) resident bytes per query. A device kernel would need
the full table resident in device memory, which is the copy the
inventory exists to avoid — and at query shapes (one ``[H]`` vector
against ``[G, H]``, H ~ 128) the work is a single gemv, far below
dispatch cost. The blocked loop keeps the touched working set to one
``block_rows x H`` slab at a time so a cold query against a memory-mapped
bundle faults in pages incrementally instead of materializing ``[G, H]``.

Exactness contract (pinned by tests/test_query.py): both kernels are
EXACT-equal — indices and values — to the naive full-sort numpy
reference. Blocking never changes a row's dot product (each row's
reduction is independent), ``argpartition`` + a full sort of the k
survivors reproduces the full stable sort's top-k, and ties break by
ascending index in both paths.
"""
from __future__ import annotations

import numpy as np


def row_norms(emb: np.ndarray, block_rows: int = 8192) -> np.ndarray:
    """Float32 L2 norm per row, computed in ``block_rows`` slabs.

    This is the ONE norm definition both bundle publication
    (io/writers.py) and query-time scoring use, so precomputed bundle
    norms and any recomputation agree bitwise.
    """
    g = emb.shape[0]
    out = np.empty(g, dtype=np.float32)
    for lo in range(0, g, block_rows):
        hi = min(g, lo + block_rows)
        block = np.asarray(emb[lo:hi], dtype=np.float32)
        out[lo:hi] = np.sqrt(np.einsum("ij,ij->i", block, block))
    return out


def _topk_desc(values: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest values, descending, ties by ascending
    index — via partial select (``argpartition``), never a full sort."""
    g = values.shape[0]
    k = min(k, g)
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    if k < g:
        cand = np.argpartition(-values, k - 1)[:k]
        # argpartition picks an ARBITRARY element among values tied at
        # the k-boundary; the stable full sort picks the lowest index.
        # Re-derive the boundary cohort: everything strictly above the
        # threshold is in (< k of those exist), then tied rows fill the
        # remaining slots in ascending-index order (flatnonzero is
        # already ascending).
        thresh = values[cand].min()
        above = np.flatnonzero(values > thresh)
        ties = np.flatnonzero(values == thresh)
        cand = np.concatenate([above, ties[:k - above.size]])
    else:
        cand = np.arange(g)
    # Full sort only over the k survivors: primary key value desc,
    # secondary key index asc (lexsort's last key is primary).
    order = np.lexsort((cand, -values[cand]))
    return cand[order].astype(np.int64)


def cosine_topk(emb: np.ndarray, norms: np.ndarray, q: np.ndarray,
                k: int, exclude: int = -1,
                block_rows: int = 8192) -> "tuple[np.ndarray, np.ndarray]":
    """Exact cosine nearest neighbors of ``q`` among the rows of ``emb``.

    ``emb`` may be an ``np.memmap``; only one ``block_rows x H`` slab is
    materialized at a time (plus the ``[G]`` score vector). ``norms``
    are the precomputed :func:`row_norms`. Zero-norm rows (and a
    zero-norm query) score ``-2.0`` — strictly below every real cosine
    — instead of dividing by zero. ``exclude`` (the query gene itself)
    is scored out with ``-inf``. Returns ``(idx, sims)`` with the k
    best rows, similarity descending, ties by ascending index.
    """
    g, h = emb.shape
    q = np.asarray(q, dtype=np.float32).reshape(h)
    qn = np.sqrt(np.dot(q, q))
    sims = np.empty(g, dtype=np.float32)
    for lo in range(0, g, block_rows):
        hi = min(g, lo + block_rows)
        block = np.asarray(emb[lo:hi], dtype=np.float32)
        sims[lo:hi] = block @ q
    denom = norms * qn
    ok = denom > 0
    sims = np.where(ok, sims / np.where(ok, denom, 1), np.float32(-2.0))
    if 0 <= exclude < g:
        sims[exclude] = -np.inf
    idx = _topk_desc(sims, k)
    return idx, sims[idx]


def cosine_topk_subset(emb: np.ndarray, norms: np.ndarray,
                       rows: np.ndarray, q: np.ndarray, k: int,
                       exclude: int = -1, block_rows: int = 8192
                       ) -> "tuple[np.ndarray, np.ndarray]":
    """:func:`cosine_topk` restricted to a candidate subset of rows.

    ``rows`` MUST be sorted ascending and duplicate-free (the IVF
    probe in ops/ann.py produces exactly that); sortedness is what
    makes tie-breaking identical to the full kernel — position order
    within the candidate score vector IS ascending global row id, so
    ``_topk_desc``'s ascending-position tie rule resolves ties by
    ascending global index, same as the exact path.

    Float-exactness contract (pinned by tests/test_ann.py): each
    candidate row's score is computed with the SAME arithmetic as
    :func:`cosine_topk` — one row dot ``emb[r] @ q``, the same
    ``np.where`` zero-norm guard, the same ``-inf`` exclude — and a
    row's dot product does not depend on which other rows share its
    block. So whenever the true top-k rows are all in ``rows``, the
    returned (idx, sims) equal the exact kernel's bitwise.
    """
    g, h = emb.shape
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    m = rows.shape[0]
    q = np.asarray(q, dtype=np.float32).reshape(h)
    qn = np.sqrt(np.dot(q, q))
    sims = np.empty(m, dtype=np.float32)
    for lo in range(0, m, block_rows):
        hi = min(m, lo + block_rows)
        # Fancy-indexed gather materializes one candidate slab at a
        # time; a memory-mapped ``emb`` faults only the touched pages.
        block = np.asarray(emb[rows[lo:hi]], dtype=np.float32)
        sims[lo:hi] = block @ q
    denom = np.asarray(norms, dtype=np.float32)[rows] * qn
    ok = denom > 0
    sims = np.where(ok, sims / np.where(ok, denom, 1), np.float32(-2.0))
    if 0 <= exclude < g:
        pos = np.searchsorted(rows, exclude)
        if pos < m and rows[pos] == exclude:
            sims[pos] = -np.inf
    loc = _topk_desc(sims, k)
    return rows[loc], sims[loc]


def topk_scores(scores: np.ndarray, k: int
                ) -> "tuple[np.ndarray, np.ndarray]":
    """Top-k indices of a 1-D score vector by partial select.

    The biomarker sub-op's kernel: one row of the bundle's ``[2, G]``
    prognostic score matrix in, ``(idx, scores[idx])`` out — score
    descending, ties by ascending index, exact-equal to the full stable
    sort.
    """
    scores = np.asarray(scores, dtype=np.float32).reshape(-1)
    idx = _topk_desc(scores, k)
    return idx, scores[idx]
