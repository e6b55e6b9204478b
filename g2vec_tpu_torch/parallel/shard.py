"""Gene-range and walk-partition sharding of the streaming run.

The port of ``g2vec_tpu/parallel/shard.py``: its partitioning
arithmetic, its shard context and its edge partition. Two axes, two
flags, and the edge partition on top of them:

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

- ``--edge-partition handoff|halo`` partitions the graph itself: a rank
  reads and holds only the CSR rows of its own gene range
  (:func:`edge_range`, plain ``r*G/R`` splits of the rows), and the walk
  of a shard becomes a collective (:func:`run_edge_walk`): a walk that
  steps onto a gene whose row another rank holds suspends, and its
  explicit state (row, current gene, stream, position, path prefix)
  travels to that rank, which resumes it bit for bit. ``halo`` also
  replicates the rows of the 1-hop neighbours outside the range
  (:func:`build_halo_csr`), so most walks finish where they are. The
  rows are the unpartitioned walk's bytes either way.

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
from typing import List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# The edge partition (--edge-partition): each rank holds the CSR rows of its
# own gene range, and walks that leave it travel as explicit state.
# ---------------------------------------------------------------------------


def edge_range(rank: int, n_ranks: int, n_genes: int) -> Tuple[int, int]:
    """The rank's gene range [lo, hi) on the edge-partition axis: plain
    ``r*G/R`` splits (no byte alignment: this axis cuts CSR rows, not
    packed columns)."""
    if not (0 <= rank < max(1, n_ranks)):
        raise ValueError(f"rank {rank} outside n_ranks {n_ranks}")
    return (rank * n_genes // max(1, n_ranks),
            (rank + 1) * n_genes // max(1, n_ranks))


def edge_bounds(n_ranks: int, n_genes: int) -> np.ndarray:
    """[R] int64 lower bounds of the ranks' ranges (for
    :func:`owners_of`)."""
    return np.array([r * n_genes // n_ranks for r in range(n_ranks)],
                    dtype=np.int64)


def owners_of(genes: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """The rank whose range holds each gene id, under :func:`edge_bounds`."""
    return (np.searchsorted(bounds, np.asarray(genes, dtype=np.int64),
                            side="right") - 1).astype(np.int32)


@dataclasses.dataclass
class PartitionedCSR:
    """One rank's part of a group's walk graph.

    ``indptr`` spans the whole gene axis (G+1 entries) but only the rows
    with ``avail[g] == 1`` hold edges: the owned rows, and in halo mode the
    halo rows. The partial walk suspends a walk whose current gene has
    ``avail == 0`` before it scans the row, so an empty row that is not
    held never passes for a dead end.
    """

    n_genes: int
    lo: int
    hi: int
    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    avail: np.ndarray               # uint8 [G]
    halo_genes: np.ndarray          # int32, sorted; empty unless halo
    owned_edges: int
    halo_edges: int = 0

    @property
    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (self.indptr, self.indices, self.weights)

    @property
    def csr_bytes(self) -> int:
        """The bytes this rank holds of the graph: indptr, indices,
        weights and the avail mask."""
        return (self.indptr.nbytes + self.indices.nbytes
                + self.weights.nbytes + self.avail.nbytes)

    @property
    def halo_bytes(self) -> int:
        """The bytes of the replicated halo rows (8 an edge: index and
        weight)."""
        return 8 * self.halo_edges

    @property
    def halo_overhead_ratio(self) -> float:
        """Halo bytes over the owned rows' bytes: what finishing boundary
        walks locally costs in memory."""
        owned = 8 * self.owned_edges
        return (self.halo_bytes / owned) if owned else 0.0


def build_partitioned_csr(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                          n_genes: int, lo: int, hi: int) -> PartitionedCSR:
    """The owned rows' CSR from a range-filtered edge list. Every ``src``
    must already lie in [lo, hi): the reader filtered them, and this
    checks the contract instead of filtering again, so nothing here ever
    sees the whole edge list."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = np.asarray(w)
    if src.size and (src.min() < lo or src.max() >= hi):
        raise ValueError(
            f"edge sources outside the owned range [{lo}, {hi}) — the "
            f"range-filtered reader must only hand this rank its own rows")
    if dst.size and (dst.min() < 0 or dst.max() >= n_genes):
        raise ValueError(f"dst contains node ids outside [0, {n_genes})")
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr

    indptr, indices, weights = edges_to_csr(src, dst, w, n_genes)
    avail = np.zeros(n_genes, dtype=np.uint8)
    avail[lo:hi] = 1
    return PartitionedCSR(
        n_genes=n_genes, lo=lo, hi=hi, indptr=indptr, indices=indices,
        weights=weights, avail=avail,
        halo_genes=np.zeros(0, dtype=np.int32), owned_edges=int(src.size))


def _savez_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _loadz_bytes(raw: bytes) -> dict:
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def build_halo_csr(pcsr: PartitionedCSR, *, rank: int, n_ranks: int,
                   group: int, exchange=None,
                   deadline: Optional[float] = None) -> PartitionedCSR:
    """Replicate the rows of the 1-hop neighbours outside this rank's
    range onto it, a collective of every rank.

    Two all-pairs rounds over the explicit-key transport
    (:func:`.hostcomm.exchange_bytes`): each rank publishes, for each
    peer, the sorted genes it wants from that peer's range, then serves
    the rows it was asked for. A rank killed between the rounds (the
    ``halo_build`` seam) leaves its peers waiting on its rows until their
    deadline names it.
    """
    from g2vec_tpu_torch.parallel import hostcomm
    from g2vec_tpu_torch.resilience.faults import fault_point

    if n_ranks == 1:
        return pcsr
    if exchange is None:
        exchange = hostcomm.exchange_bytes
    bounds = edge_bounds(n_ranks, pcsr.n_genes)
    outside = pcsr.indices[(pcsr.indices < pcsr.lo)
                           | (pcsr.indices >= pcsr.hi)]
    wants = np.unique(outside).astype(np.int64)
    want_owner = owners_of(wants, bounds)
    kw = dict(deadline=deadline) if deadline else {}
    for b in range(n_ranks):
        if b == rank:
            continue
        payload = _savez_bytes(genes=wants[want_owner == b].astype(np.int32))
        exchange(f"halo/g{group}/want/{rank}to{b}", payload, rank, **kw)
    requests = {}
    for a in range(n_ranks):
        if a == rank:
            continue
        raw = exchange(f"halo/g{group}/want/{a}to{rank}", None, a, **kw)
        requests[a] = _loadz_bytes(raw)["genes"].astype(np.int64)
    # The dead server's seam: a sigkill here, after the want lists and
    # before any rows, leaves every requester waiting on this rank.
    fault_point("halo_build", epoch=group)
    for b, req in requests.items():
        counts = (pcsr.indptr[req + 1] - pcsr.indptr[req]).astype(np.int32)
        slices = [pcsr.indices[pcsr.indptr[g]:pcsr.indptr[g + 1]]
                  for g in req]
        wslices = [pcsr.weights[pcsr.indptr[g]:pcsr.indptr[g + 1]]
                   for g in req]
        payload = _savez_bytes(
            genes=req.astype(np.int32), counts=counts,
            indices=(np.concatenate(slices) if slices
                     else np.zeros(0, np.int32)),
            weights=(np.concatenate(wslices) if wslices
                     else np.zeros(0, np.float32)))
        exchange(f"halo/g{group}/rows/{rank}to{b}", payload, rank, **kw)
    halo_src, halo_dst, halo_w, halo_genes = [], [], [], []
    for a in range(n_ranks):
        if a == rank:
            continue
        raw = exchange(f"halo/g{group}/rows/{a}to{rank}", None, a, **kw)
        z = _loadz_bytes(raw)
        halo_genes.append(z["genes"].astype(np.int32))
        halo_src.append(np.repeat(z["genes"].astype(np.int32),
                                  z["counts"].astype(np.int64)))
        halo_dst.append(z["indices"].astype(np.int32))
        halo_w.append(z["weights"].astype(np.float32))
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr

    own_src = np.repeat(np.arange(pcsr.n_genes, dtype=np.int32),
                        np.diff(pcsr.indptr).astype(np.int64))
    src = np.concatenate([own_src] + halo_src)
    dst = np.concatenate([pcsr.indices] + halo_dst)
    w = np.concatenate([pcsr.weights] + halo_w)
    indptr, indices, weights = edges_to_csr(src, dst, w, pcsr.n_genes)
    genes = np.sort(np.concatenate(halo_genes)) if halo_genes \
        else np.zeros(0, np.int32)
    avail = pcsr.avail.copy()
    avail[genes] = 1
    return PartitionedCSR(
        n_genes=pcsr.n_genes, lo=pcsr.lo, hi=pcsr.hi, indptr=indptr,
        indices=indices, weights=weights, avail=avail, halo_genes=genes,
        owned_edges=pcsr.owned_edges,
        halo_edges=int(src.size - own_src.size))


@dataclasses.dataclass
class EdgeWalkStats:
    """The handoff's counts over a run's shards (the ``handoff`` metrics
    event)."""

    shards: int = 0
    rounds: int = 0
    states_sent: int = 0            # suspended walk states shipped
    batches: int = 0                # non-empty batches, one a destination
    peak_in_flight: int = 0         # most states in flight in one round


@dataclasses.dataclass
class EdgeContext:
    """What the pipeline hands the streaming trainer for a multi-rank
    edge-partitioned run: the groups' partial CSRs (halo rows merged in
    halo mode) and the run's handoff counts. A one-rank run passes None:
    its range is the whole graph and the trainer's plain paths apply
    (byte identity)."""

    mode: str                       # "handoff" | "halo"
    pcsrs: List[PartitionedCSR]     # one a prognosis group
    stats: EdgeWalkStats


def run_edge_walk(pcsr: PartitionedCSR, plan, shard_index: int, *,
                  seed: int, owner: int, rank: int, n_ranks: int,
                  starts: Optional[np.ndarray] = None, n_threads: int = 0,
                  exchange=None, deadline: Optional[float] = None,
                  key_prefix: str = "edge", cancelled=None,
                  stats: Optional[EdgeWalkStats] = None
                  ) -> Optional[np.ndarray]:
    """Walk one group's shard over the ranks' partial CSRs, a collective.

    Every rank calls this for every (shard, group) in the same order. The
    shard's owner seeds the walk states
    (:func:`~g2vec_tpu_torch.ops.host_walker.shard_walk_states`); each
    round every rank advances the states it holds on the C++ sampler,
    keeps its finished paths (or sends them to the owner) and ships the
    suspended states to the rank whose range holds their current gene,
    finished paths riding the same payloads. Each payload carries its
    sender's count of states sent, so every rank sums the same in-flight
    total and the loop ends on the same round everywhere: one all-pairs
    round even when no walk crosses a range.

    Returns the shard-group's packed rows on the owner
    (:func:`~g2vec_tpu_torch.ops.host_walker.walk_shard`'s layout and
    bytes) and None on the other ranks, or None anywhere once
    ``cancelled()`` reports that the consumer is gone.
    """
    import time as _time

    from g2vec_tpu_torch.ops.host_walker import (WalkStateBatch,
                                                 advance_walk_states,
                                                 pack_finished_paths,
                                                 shard_walk_states)
    from g2vec_tpu_torch.resilience.faults import fault_point

    len_path = plan.len_path
    n_rows = plan.group_rows(shard_index)
    if n_ranks == 1:
        states = shard_walk_states(plan, shard_index, seed=seed,
                                   starts=starts)
        status = advance_walk_states(states, pcsr.csr, pcsr.n_genes,
                                     pcsr.avail, len_path,
                                     n_threads=n_threads)
        if status.any():
            raise RuntimeError(
                "single-rank edge-partitioned walk suspended — the full "
                "range must be available")
        return pack_finished_paths(states.paths, pcsr.n_genes)

    from g2vec_tpu_torch.parallel import hostcomm

    if exchange is None:
        exchange = hostcomm.exchange_bytes
    budget = deadline if deadline else hostcomm.DEFAULT_DEADLINE_S
    t_end = _time.monotonic() + budget

    def _recv(key: str, src_rank: int) -> Optional[bytes]:
        """A receive in slices of at most 2 s that notices a cancelled
        consumer between them."""
        while True:
            left = t_end - _time.monotonic()
            if left <= 0:
                # The transport's own naming of the peer that never sent.
                return exchange(key, None, src_rank, deadline=1e-3)
            try:
                return exchange(key, None, src_rank,
                                deadline=min(2.0, left))
            except hostcomm.PeerTimeoutError:
                if cancelled is not None and cancelled():
                    return None

    bounds = edge_bounds(n_ranks, pcsr.n_genes)
    i_am_owner = rank == owner
    pending = (shard_walk_states(plan, shard_index, seed=seed, starts=starts)
               if i_am_owner else WalkStateBatch.empty(len_path))
    done_paths = (np.full((n_rows, len_path), -1, np.int32)
                  if i_am_owner else None)
    n_done = 0
    rnd = 0
    if stats is not None:
        stats.shards += 1
    while True:
        fin = WalkStateBatch.empty(len_path)
        out: dict = {}
        if len(pending):
            status = advance_walk_states(pending, pcsr.csr, pcsr.n_genes,
                                         pcsr.avail, len_path,
                                         n_threads=n_threads)
            fin = pending.take(np.nonzero(status == 0)[0])
            sus = pending.take(np.nonzero(status == 1)[0])
            dest = owners_of(sus.cur, bounds)
            for b in range(n_ranks):
                sel = np.nonzero(dest == b)[0]
                if sel.size:
                    out[b] = sus.take(sel)
        if i_am_owner and len(fin):
            done_paths[fin.row] = fin.paths
            n_done += len(fin)
            fin = WalkStateBatch.empty(len_path)
        my_out = sum(len(b) for b in out.values())
        if stats is not None:
            stats.rounds += 1
            stats.states_sent += my_out
            stats.batches += sum(1 for b in out.values() if len(b))
        # The mid-walk seam: a rank killed here holds suspended walk
        # state no other rank can rebuild; the survivors' receive
        # deadline names it.
        fault_point("walk_handoff", epoch=shard_index)
        for b in range(n_ranks):
            if b == rank:
                continue
            batch = out.get(b, WalkStateBatch.empty(len_path))
            f = fin if b == owner else WalkStateBatch.empty(len_path)
            payload = _savez_bytes(
                row=batch.row, cur=batch.cur, rng=batch.rng, pos=batch.pos,
                paths=batch.paths, fin_row=f.row, fin_paths=f.paths,
                live=np.array([my_out], np.int64))
            exchange(f"{key_prefix}/{shard_index}/r{rnd}/{rank}to{b}",
                     payload, rank)
        incoming = [out[rank]] if rank in out else []
        global_live = my_out
        for a in range(n_ranks):
            if a == rank:
                continue
            raw = _recv(f"{key_prefix}/{shard_index}/r{rnd}/{a}to{rank}", a)
            if raw is None:
                return None          # the consumer is gone: exit quietly
            z = _loadz_bytes(raw)
            global_live += int(z["live"][0])
            if z["row"].size:
                incoming.append(WalkStateBatch(
                    row=z["row"].astype(np.int32),
                    cur=z["cur"].astype(np.int32),
                    rng=z["rng"].astype(np.uint64),
                    pos=z["pos"].astype(np.int32),
                    paths=z["paths"].astype(np.int32)))
            if i_am_owner and z["fin_row"].size:
                done_paths[z["fin_row"].astype(np.int64)] = \
                    z["fin_paths"].astype(np.int32)
                n_done += int(z["fin_row"].size)
        if stats is not None:
            stats.peak_in_flight = max(stats.peak_in_flight, global_live)
        pending = (WalkStateBatch.concat(incoming) if incoming
                   else WalkStateBatch.empty(len_path))
        rnd += 1
        if global_live == 0:
            break
    if not i_am_owner:
        return None
    if n_done != n_rows:
        raise RuntimeError(
            f"edge walk for shard {shard_index} terminated with "
            f"{n_done}/{n_rows} rows assembled — protocol bug")
    return pack_finished_paths(done_paths, pcsr.n_genes)
