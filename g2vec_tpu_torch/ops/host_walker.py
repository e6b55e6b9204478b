"""Stage-3 path generation on the host's C++ sampler.

Same walk contract as ``g2vec_tpu/ops/host_walker.py``: every gene a start
node ``reps`` times (ref: G2Vec.py:324-352), no revisits, weight-
proportional steps, dead-end stop; walker ``i`` of the flat
(repetition x start) axis draws from the splitmix64 stream keyed by
``(seed, i)``. The packed rows are therefore byte-identical to the JAX
package's sampler for the same edges and seed, at any thread count.
"""
from __future__ import annotations

import os
from typing import Set

import numpy as np


def resolve_sampler_threads(n_threads: int = 0) -> int:
    """``--sampler-threads`` -> a concrete count (0 = every core)."""
    if n_threads < 0:
        raise ValueError(f"sampler threads must be >= 0, got {n_threads}")
    return n_threads or max(1, os.cpu_count() or 1)


def edges_to_csr(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 n_genes: int):
    """(src, dst, w) edge lists -> CSR (indptr [G+1], indices [E], w [E]).

    Directed, duplicate edges kept, rows in stable source order.
    """
    order = np.argsort(src, kind="stable")
    indices = np.ascontiguousarray(dst[order], dtype=np.int32)
    weights = np.ascontiguousarray(w[order], dtype=np.float32)
    counts = np.bincount(src, minlength=n_genes)
    indptr = np.zeros(n_genes + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices, weights


def walk_packed_rows(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                     n_genes: int, *, len_path: int, reps: int, seed: int,
                     n_threads: int = 0) -> np.ndarray:
    """All-sources x reps walks -> [n_genes * reps, ceil(G/8)] uint8 packed
    multi-hot rows in walker order (rep-major), NOT deduplicated."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed

    for name, arr in (("dst", dst), ("src", src)):
        if arr.size and (arr.min() < 0 or arr.max() >= n_genes):
            raise ValueError(
                f"{name} contains node ids outside [0, {n_genes})")
    starts = np.tile(np.arange(n_genes, dtype=np.int32), reps)
    # Stream identity = rep * n_genes + start index: adding repetitions
    # extends the stream family and never re-keys an existing walker.
    stream_ids = np.arange(starts.shape[0], dtype=np.uint64)
    indptr, indices, weights = edges_to_csr(src, dst, w, n_genes)
    return walk_paths_packed(indptr, indices, weights, n_genes, starts,
                             stream_ids, len_path, seed,
                             n_threads=resolve_sampler_threads(n_threads))


def generate_path_set_native(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                             n_genes: int, *, len_path: int, reps: int,
                             seed: int, n_threads: int = 0) -> Set[bytes]:
    """All-sources x reps walks -> the set of packed multi-hot rows
    (generate_pathSet, ref: G2Vec.py:324-352, set-deduplicated)."""
    packed = walk_packed_rows(src, dst, w, n_genes, len_path=len_path,
                              reps=reps, seed=seed, n_threads=n_threads)
    return {row.tobytes() for row in packed}
