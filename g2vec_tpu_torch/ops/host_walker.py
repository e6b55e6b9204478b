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
from dataclasses import dataclass
from typing import Optional, Set

import numpy as np

from g2vec_tpu_torch.utils.timing import span


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
                     n_threads: int = 0, walker_lo: int = 0,
                     walker_hi: Optional[int] = None) -> np.ndarray:
    """The walks of the walker range ``[walker_lo, walker_hi)`` of the
    flat all-sources x reps axis (rep-major; default: all of it) ->
    [n, ceil(G/8)] uint8 packed multi-hot rows in walker order, NOT
    deduplicated. A walker's stream is keyed by its global index, so any
    split of the axis (a rank's range, ``parallel.distributed.
    sharded_native_path_set``) gives the rows the whole call gives."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed

    for name, arr in (("dst", dst), ("src", src)):
        if arr.size and (arr.min() < 0 or arr.max() >= n_genes):
            raise ValueError(
                f"{name} contains node ids outside [0, {n_genes})")
    total = n_genes * reps
    walker_hi = total if walker_hi is None else walker_hi
    if not 0 <= walker_lo <= walker_hi <= total:
        raise ValueError(
            f"walker range [{walker_lo}, {walker_hi}) outside [0, {total}]")
    starts = np.tile(np.arange(n_genes, dtype=np.int32),
                     reps)[walker_lo:walker_hi]
    # Stream identity = rep * n_genes + start index: adding repetitions
    # extends the stream family and never re-keys an existing walker.
    stream_ids = np.arange(walker_lo, walker_hi, dtype=np.uint64)
    indptr, indices, weights = edges_to_csr(src, dst, w, n_genes)
    return walk_paths_packed(indptr, indices, weights, n_genes, starts,
                             stream_ids, len_path, seed,
                             n_threads=resolve_sampler_threads(n_threads))


def generate_path_set_native(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                             n_genes: int, *, len_path: int, reps: int,
                             seed: int, n_threads: int = 0) -> Set[bytes]:
    """All-sources x reps walks -> the set of packed multi-hot rows
    (generate_pathSet, ref: G2Vec.py:324-352, set-deduplicated); the set
    is the span ``row_set``."""
    packed = walk_packed_rows(src, dst, w, n_genes, len_path=len_path,
                              reps=reps, seed=seed, n_threads=n_threads)
    with span("row_set"):
        return {row.tobytes() for row in packed}


@dataclass(frozen=True)
class ShardPlan:
    """The deterministic shard decomposition of one run's walker axis
    (``g2vec_tpu/ops/host_walker.py``'s, for the streaming trainer).

    Shard ``s`` holds the START-GENE range ``[s*k, (s+1)*k)`` with all its
    repetitions, for both groups: the flat walker axis is rep-major, so
    one shard is ``reps`` strided slices of each group's axis. Every copy
    of a start gene's walks (all reps, both groups) lands in one shard,
    where the per-shard common-path filter catches it. Walker streams are
    keyed by global walker index, so a shard's rows are the same bytes at
    any thread count and any ring depth.
    """

    n_starts: int           # common genes (each group's start list)
    reps: int
    starts_per_shard: int   # k
    len_path: int

    @property
    def n_walkers(self) -> int:
        """Per group: the flat walker-axis length."""
        return self.n_starts * self.reps

    @property
    def n_shards(self) -> int:
        return -(-self.n_starts // self.starts_per_shard)

    @property
    def rows_per_shard(self) -> int:
        """Nominal rows in a full shard (both groups, all reps)."""
        return 2 * self.starts_per_shard * self.reps

    def start_range(self, shard: int) -> tuple:
        """[lo, hi) of the start-gene axis covered by ``shard``."""
        lo = shard * self.starts_per_shard
        return lo, min(lo + self.starts_per_shard, self.n_starts)

    def group_rows(self, shard: int) -> int:
        """Rows ``shard`` holds per group."""
        lo, hi = self.start_range(shard)
        return (hi - lo) * self.reps


#: Auto ``--shard-paths``: 4,096 rows a shard, both groups together.
AUTO_SHARD_PATHS = 4096


def plan_shards(n_genes: int, reps: int, shard_paths: int, *,
                len_path: int) -> ShardPlan:
    """Shard the walker axis into shards of about ``shard_paths`` rows
    (both groups' rows across all reps; 0 = :data:`AUTO_SHARD_PATHS`)."""
    if shard_paths < 0:
        raise ValueError(f"shard_paths must be >= 0, got {shard_paths}")
    if shard_paths == 0:
        shard_paths = AUTO_SHARD_PATHS
    starts_per_shard = max(1, min(shard_paths // (2 * reps), n_genes))
    return ShardPlan(n_starts=n_genes, reps=reps,
                     starts_per_shard=starts_per_shard, len_path=len_path)


def walk_shard(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
               n_genes: int, plan: ShardPlan, shard: int, *, seed: int,
               n_threads: int = 0, csr: Optional[tuple] = None,
               starts: Optional[np.ndarray] = None) -> np.ndarray:
    """One group's rows of shard ``shard`` -> [group_rows, ceil(G/8)]
    uint8 packed rows, not deduplicated, rep-major: rep ``r``'s block
    holds walkers ``[r*n_starts + lo, r*n_starts + hi)`` in walker order,
    each walker keyed by its global index, so every row is byte for byte
    the full-range call's row for that walker. A pure function of (plan,
    shard, seed, starts): the spool re-walks a shard that failed
    verification. ``csr`` is the group's prebuilt :func:`edges_to_csr`.
    ``starts`` restricts the start genes to a subset (``--walk-starts``,
    :func:`~g2vec_tpu_torch.parallel.shard.subset_starts`); the plan's
    ``n_starts`` is then ``len(starts)`` and walker indices count into the
    subset, as in the JAX package.
    """
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed

    if starts is not None and len(starts) != plan.n_starts:
        raise ValueError(
            f"plan.n_starts ({plan.n_starts}) must match len(starts) "
            f"({len(starts)})")
    lo, hi = plan.start_range(shard)
    sub = (np.arange(lo, hi, dtype=np.int32) if starts is None
           else np.ascontiguousarray(starts[lo:hi], dtype=np.int32))
    starts = np.tile(sub, plan.reps)
    stream_ids = (np.arange(plan.reps, dtype=np.uint64)[:, None]
                  * np.uint64(plan.n_starts)
                  + np.arange(lo, hi, dtype=np.uint64)[None, :]).ravel()
    if csr is None:
        csr = edges_to_csr(src, dst, w, n_genes)
    return walk_paths_packed(*csr, n_genes, starts, stream_ids,
                             plan.len_path, seed,
                             n_threads=resolve_sampler_threads(n_threads))


@dataclass
class WalkStateBatch:
    """Explicit, relocatable state of a batch of walkers: the resumable
    form of the state a walker keeps inside the C++ sampler
    (``g2vec_tpu/ops/host_walker.py:334``).

    ``row`` is the walker's row in its shard-group block (rep-major,
    :func:`walk_shard`'s layout), ``rng`` its raw splitmix64 state, and
    the visited set is the path prefix. So a walk writes the same bytes
    on whichever rank, and in however many pieces, it runs: the edge
    partition (:mod:`..parallel.shard`) suspends walkers at the edge of a
    rank's rows, ships them to the rank holding the row, and resumes them
    there.
    """

    row: np.ndarray      # int32 [M] row within the shard-group block
    cur: np.ndarray      # int32 [M] current gene (the path's tail)
    rng: np.ndarray      # uint64 [M] raw splitmix64 state
    pos: np.ndarray      # int32 [M] genes taken so far (>= 1)
    paths: np.ndarray    # int32 [M, len_path] path prefix, -1 after it

    def __len__(self) -> int:
        return self.row.shape[0]

    def take(self, idx: np.ndarray) -> "WalkStateBatch":
        return WalkStateBatch(
            row=np.ascontiguousarray(self.row[idx]),
            cur=np.ascontiguousarray(self.cur[idx]),
            rng=np.ascontiguousarray(self.rng[idx]),
            pos=np.ascontiguousarray(self.pos[idx]),
            paths=np.ascontiguousarray(self.paths[idx]))

    @staticmethod
    def concat(batches: "list[WalkStateBatch]") -> "WalkStateBatch":
        return WalkStateBatch(
            row=np.concatenate([b.row for b in batches]),
            cur=np.concatenate([b.cur for b in batches]),
            rng=np.concatenate([b.rng for b in batches]),
            pos=np.concatenate([b.pos for b in batches]),
            paths=np.concatenate([b.paths for b in batches], axis=0))

    @staticmethod
    def empty(len_path: int) -> "WalkStateBatch":
        return WalkStateBatch(
            row=np.zeros(0, np.int32), cur=np.zeros(0, np.int32),
            rng=np.zeros(0, np.uint64), pos=np.zeros(0, np.int32),
            paths=np.zeros((0, len_path), np.int32))


def shard_walk_states(plan: ShardPlan, shard: int, *, seed: int,
                      starts: Optional[np.ndarray] = None) -> WalkStateBatch:
    """The first :class:`WalkStateBatch` of every walker of one group's
    shard ``shard``: :func:`walk_shard`'s row order and streams, so the
    states advanced to their ends and packed are :func:`walk_shard`'s
    rows, byte for byte."""
    from g2vec_tpu_torch.native.walker_bindings import init_walk_state

    if starts is not None and len(starts) != plan.n_starts:
        raise ValueError(
            f"plan.n_starts ({plan.n_starts}) must match len(starts) "
            f"({len(starts)})")
    lo, hi = plan.start_range(shard)
    sub = (np.arange(lo, hi, dtype=np.int32) if starts is None
           else np.ascontiguousarray(starts[lo:hi], dtype=np.int32))
    start_col = np.tile(sub, plan.reps)
    wids = (np.arange(plan.reps, dtype=np.uint64)[:, None]
            * np.uint64(plan.n_starts)
            + np.arange(lo, hi, dtype=np.uint64)[None, :]).ravel()
    n = start_col.shape[0]
    paths = np.full((n, plan.len_path), -1, np.int32)
    paths[:, 0] = start_col
    return WalkStateBatch(row=np.arange(n, dtype=np.int32),
                          cur=np.ascontiguousarray(start_col),
                          rng=init_walk_state(seed, wids),
                          pos=np.ones(n, np.int32), paths=paths)


def advance_walk_states(states: WalkStateBatch, csr: tuple, n_genes: int,
                        avail: np.ndarray, len_path: int,
                        n_threads: int = 0) -> np.ndarray:
    """Advance every walk of ``states`` in place on the C++ sampler over
    an availability-masked CSR, until it finishes (full length or dead
    end) or suspends on a gene whose row is not held here. Returns the
    [M] uint8 status (0 finished, 1 suspended)."""
    from g2vec_tpu_torch.native.walker_bindings import walk_partial

    indptr, indices, weights = csr
    return walk_partial(indptr, indices, weights, n_genes, avail,
                        states.cur, states.rng, states.pos, states.paths,
                        len_path, n_threads=resolve_sampler_threads(n_threads))


def pack_finished_paths(paths: np.ndarray, n_genes: int,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """[M, len_path] finished paths -> :func:`walk_shard`'s packed rows."""
    from g2vec_tpu_torch.native.walker_bindings import pack_paths

    return pack_paths(paths, n_genes, out=out)
