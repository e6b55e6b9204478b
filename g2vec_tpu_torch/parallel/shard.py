"""Gene-range and walk-partition sharding of the streaming run.

The port's copy of ``g2vec_tpu/parallel/shard.py``'s partitioning
arithmetic and shard context (not its edge partition). Two axes, two
flags:

- ``--graph-shards N`` cuts the streaming walk-shard sequence into N
  contiguous partitions; partition ``p`` is walked only by rank
  ``p % n_ranks``, which publishes the packed rows to the others over the
  store (:func:`.hostcomm.exchange_bytes`). Every rank still spools and
  trains on every shard.
- ``--embed-shards R`` splits the ``[G, H]`` embedding by a byte-aligned
  gene range per rank (R must equal the process count): a rank holds and
  trains ``[G/R, H]`` on its byte columns of the packed rows
  (:mod:`..train.shard`), the head ``w_ho`` stays replicated because
  every rank applies the same update to the same reduced activations, and
  stages 5-6 run on the local slice with only per-cluster statistics and
  masked extrema crossing ranks; full-width vectors are gathered at the
  writers alone.

Byte-aligned ranges: walk rows are np.packbits rows (8 genes a byte, MSB
first). A range that starts on a multiple of 8 is a slice of whole byte
columns, ``rows[:, lo // 8 : (hi + 7) // 8]``, so a rank never unpacks
more than its own genes.

The allreduce is a host one in rank order over the store: every rank
folds the gathered stack left to right, so replicated state stays the
same bits on every rank.

Parity contract: at ``n_ranks == 1`` the sharded mode runs exactly the
unsharded code (the local range is the whole range, the exchange a
passthrough) and writes the same bytes. At ``n_ranks > 1`` the hidden
activations are summed in another order than one matmul's, so the
contract is the statistical one (val accuracy band, biomarker overlap).
"""
from __future__ import annotations

import dataclasses
import io
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The partitioning arithmetic. ``embed_shards > 0`` splits the gene
    range (and must then equal ``n_ranks``); ``graph_shards > 0`` splits
    the walk-shard ownership. Either axis alone is a valid mode."""

    rank: int
    n_ranks: int
    n_genes: int
    graph_shards: int = 0
    embed_shards: int = 0

    def __post_init__(self):
        if not (0 <= self.rank < max(1, self.n_ranks)):
            raise ValueError(f"rank {self.rank} outside n_ranks {self.n_ranks}")
        if self.embed_shards and self.embed_shards != self.n_ranks:
            raise ValueError(
                f"embed_shards ({self.embed_shards}) must equal the rank "
                f"count ({self.n_ranks}): the gene range is split 1:1 "
                f"across ranks")
        if self.embed_shards > 1 and self.n_genes < 8 * self.embed_shards:
            raise ValueError(
                f"embed sharding needs >= 8 genes (one packed byte) per "
                f"rank; {self.n_genes} genes across {self.embed_shards} "
                f"ranks is too few")

    # ---- the embedding (gene-range) axis ----
    @property
    def n_bytes(self) -> int:
        """Packed row width: ceil(G / 8)."""
        return (self.n_genes + 7) // 8

    def byte_range(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """The rank's contiguous slice of the packed byte columns."""
        r = self.rank if rank is None else rank
        if not self.embed_shards or self.n_ranks == 1:
            return (0, self.n_bytes)
        nb, R = self.n_bytes, self.n_ranks
        return (r * nb // R, (r + 1) * nb // R)

    def gene_range(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """The rank's gene range [lo, hi): lo a multiple of 8, hi clipped
        to G on the last rank."""
        blo, bhi = self.byte_range(rank)
        return (blo * 8, min(bhi * 8, self.n_genes))

    @property
    def lo(self) -> int:
        return self.gene_range()[0]

    @property
    def hi(self) -> int:
        return self.gene_range()[1]

    @property
    def g_local(self) -> int:
        return self.hi - self.lo

    @property
    def embed_split(self) -> bool:
        """True when the trainer and stages 5-6 take the split path; one
        rank stays on the plain code (the byte-identity contract)."""
        return bool(self.embed_shards) and self.n_ranks > 1

    def slice_packed(self, rows: np.ndarray) -> np.ndarray:
        """The local byte columns of full-width rows [N, ceil(G/8)]."""
        blo, bhi = self.byte_range()
        return np.ascontiguousarray(rows[:, blo:bhi])

    # ---- the walk-partition axis ----
    def shard_owner(self, si: int, n_shards: int) -> int:
        """The rank that walks streaming shard ``si`` of ``n_shards``: the
        shard sequence (start-major) is cut into ``graph_shards``
        contiguous partitions, partition ``p`` belongs to rank ``p % R``.
        With graph sharding off every rank owns everything."""
        if not self.graph_shards or self.n_ranks == 1:
            return self.rank
        if not (0 <= si < n_shards):
            raise ValueError(f"shard {si} outside [0, {n_shards})")
        p = si * self.graph_shards // n_shards
        return p % self.n_ranks


class ShardContext:
    """A :class:`ShardSpec` and the host collectives the sharded stages
    use. Every reduction here is a main-thread collective, called in one
    program order on every rank; the producer thread's walk exchange goes
    through :func:`.hostcomm.exchange_bytes` directly."""

    def __init__(self, spec: ShardSpec, *, deadline: Optional[float] = None):
        self.spec = spec
        self.deadline = deadline

    @property
    def single(self) -> bool:
        return self.spec.n_ranks == 1

    def allreduce(self, name: str, arr: np.ndarray, op: str = "sum"
                  ) -> np.ndarray:
        """Allreduce of a same-shape host array, folded left to right in
        rank order on every rank, so the result is the same bits on
        every rank."""
        arr = np.asarray(arr)
        if self.single:
            return arr
        from g2vec_tpu_torch.parallel import hostcomm

        stack = hostcomm.allgather_array(name, arr, deadline=self.deadline)
        fold = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
        acc = stack[0]
        for p in range(1, stack.shape[0]):
            acc = fold(acc, stack[p])
        return acc

    def gather_concat(self, name: str, arr: np.ndarray, axis: int = 0
                      ) -> np.ndarray:
        """Per-rank arrays (unequal along ``axis``) concatenated in rank
        order, on every rank: the writer boundary's score and L-group
        vectors, never the [G, H] table."""
        arr = np.ascontiguousarray(arr)
        if self.single:
            return arr
        from g2vec_tpu_torch.parallel import hostcomm

        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        parts = hostcomm.allgather_bytes(name, buf.getvalue(),
                                         deadline=self.deadline)
        return np.concatenate(
            [np.load(io.BytesIO(p), allow_pickle=False) for p in parts],
            axis=axis)

    def broadcast_array(self, name: str, arr: Optional[np.ndarray]
                        ) -> np.ndarray:
        """Rank 0's array, on every rank."""
        if self.single:
            if arr is None:
                raise ValueError(f"broadcast {name!r}: rank-0 array is None")
            return np.asarray(arr)
        from g2vec_tpu_torch.parallel import hostcomm

        payload = None
        if arr is not None:
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
            payload = buf.getvalue()
        raw = hostcomm.broadcast_bytes(name, payload, deadline=self.deadline)
        return np.load(io.BytesIO(raw), allow_pickle=False)


def make_shard_context(graph_shards: int, embed_shards: int, n_genes: int,
                       *, deadline: Optional[float] = None
                       ) -> Optional[ShardContext]:
    """None when both axes are off, else a context bound to this process's
    rank (:mod:`.distributed`). The embed split is checked against the
    actual process count here (the config can only check flags)."""
    if not graph_shards and not embed_shards:
        return None
    from g2vec_tpu_torch.parallel import distributed

    spec = ShardSpec(rank=distributed.process_index(),
                     n_ranks=distributed.process_count(), n_genes=n_genes,
                     graph_shards=graph_shards, embed_shards=embed_shards)
    return ShardContext(spec, deadline=deadline)


def subset_starts(n_genes: int, walk_starts: int) -> Optional[np.ndarray]:
    """Evenly spaced start genes for ``--walk-starts W``; None (every gene
    starts: the reference's walk volume, the bytes of a run without the
    flag) when W is 0 or at least G. Capping the starts, not the walk
    length, keeps every path a faithful reference walk and makes the
    total volume a budget."""
    if walk_starts <= 0 or walk_starts >= n_genes:
        return None
    idx = (np.arange(walk_starts, dtype=np.int64) * n_genes) // walk_starts
    return np.unique(idx).astype(np.int32)
