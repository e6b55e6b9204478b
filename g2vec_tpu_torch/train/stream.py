"""Streaming minibatch trainer: walk shards flow from the sampler into
minibatch SGD on the card (``--train-mode streaming``).

The port of ``g2vec_tpu/train/stream.py:train_cbow_streaming`` for one
process:

- The sampler (the C++ one, or with ``walker_backend="device"`` the
  card's walker kernel: the same bytes) walks fixed-size **walk shards**
  (:class:`~g2vec_tpu_torch.ops.host_walker.ShardPlan`: each shard is the
  same start-gene range of both groups, all reps). Shard order is
  deterministic by shard index; a shard's rows are the same bytes at any
  thread count.
- With the C++ sampler a bounded host **ring** (:class:`ShardRing`,
  ``--prefetch-depth``) carries shards from the producer (an
  overlap-scheduler task, or a thread of its own) to the trainer. A full ring blocks the producer, so
  host path memory peaks at O(shard x depth), never O(total paths).
- A **double-buffered device prefetch** puts shard b+1's train rows in
  pinned host memory and copies them ``non_blocking`` on a side stream,
  with an event the step waits on, while shard b trains.
- Epoch 0 consumes the ring: training starts the moment shard 0 lands.
  Shards are spooled to disk with a sha256 each (:class:`ShardSpool`) as
  they pass, and epochs 1..N replay the spool; a replayed shard whose
  bytes fail verification is re-walked once (determinism makes the retry
  exact), and the run raises :class:`SpoolIntegrityError` if even the
  re-walk mismatches.
- With the device walker (the reference's ``--device-feed``) epoch 0
  has no producer and no ring: each shard is walked on the card in the
  training loop, copied to the host once for the byproducts (filter,
  split, eval buffers) and for the spool, which one writer thread saves
  in the background (drained before the replay and at teardown), and the
  step's train rows are gathered from the resident shard into the layout
  the upload builds, so no packed training byte crosses from host to
  card. The outputs are
  the C++ sampler's ring feed's, byte for byte.
- The early stop reads held-out val accuracy at each epoch's end, on a
  bounded val buffer gathered from the shards' held-out rows in epoch 0,
  with ``patience`` epochs without a strict gain before it stops; the
  best epoch's snapshot is returned.

The step is one Adam step (``train.trainer._Adam``, state carried across
shards) on the masked-mean BCE over a shard's train rows. At
``compute_dtype="bfloat16"`` the forward and the backward of the shard's
product are the packed Hopper kernels (:mod:`..ops.packed_matmul`), so
both kernels run on every shard; the evals run the forward. At
``"float32"`` the dense ``torch.matmul`` path of the full-batch trainer.
The kernels take any M, so the JAX package's row padding and block-wise
re-pack of each shard are not needed: a shard's kept train rows are
uploaded as they are, each row padded once to the kernels' 4-byte stride.

Contract against full-batch: statistical (the stream trains on raw walk
rows, filtered per shard, with per-shard Adam steps). Within streaming the
trajectory is bitwise deterministic at any ``sampler_threads`` and any
``prefetch_depth``: host state advances in strict shard order and the
kernels add in a fixed order.

Durability (``checkpoint_dir``): the reference's (epoch, shard) cursor
through :func:`~g2vec_tpu_torch.train.checkpoint.save_stream_state`. Every
``checkpoint_every`` shard updates, and at every epoch boundary, the
trainer state (params, Adam, snapshot), the epoch-0 byproducts (gene
counts, the eval buffers, the kept-row count), the history and the
partial epoch's losses are saved next to a cursor naming the next shard
to train and each spooled shard's sha256. The spool is then durable
(``<checkpoint_dir>/spool``), and ``resume=True`` restarts where the
cursor points: at epoch >= 1 by replaying the verified spool from the
cursor shard, in epoch 0 by restarting the producer (or, on the device
feed, the card's walks) at the cursor shard. Every cut is at a shard
boundary and the trajectory is deterministic, so a resumed run's outputs
are the uninterrupted run's bytes.

Fault seams, where the reference has them: ``shard_ring`` in the
producer after a shard spools (a fault there surfaces at the consumer's
next ``get``; a dead consumer cancels the ring, so no kind deadlocks),
``prefetch`` as the consumer asks for each shard, ``train`` at each
epoch's end, and ``stream_ckpt`` after each cursor commits. A failed
device walk (the ``device_walk`` seam, or a kernel error) is relaunched
once, on the same kernel, and counted in ``device_recomputes``.

``check()`` runs at the top of each epoch and before each shard step (an
exception it raises stops the run there; a
:class:`~g2vec_tpu_torch.resilience.lifecycle.DrainRequested` first cuts
a cursor at that point, so the serve daemon's drain resumes there),
``lifecycle(state, info)`` observes ``"checkpointed"`` after each cursor
commits and ``"resumed"`` when a cursor is restored, and every run adds
its counters to the process-wide :func:`stream_stats` totals (the batch
engine's ``status()`` reads them).

``walk_starts`` caps the start genes at an evenly spaced subset
(:func:`~g2vec_tpu_torch.parallel.shard.subset_starts`; 0 or at least G:
every gene, the bytes of a run without it).

Scale-out over R processes (``shard_ctx``, a
:class:`~g2vec_tpu_torch.parallel.shard.ShardContext`), as the JAX
package's ``train_cbow_streaming`` does it:

- graph sharding makes the producer an exchange: the rank that owns
  shard ``si`` walks it and publishes the packed rows under ``walk/{si}``
  over the store (the ``shard_exchange`` seam fires between the walk and
  the publish); the others receive them instead of walking. Every rank
  then spools and trains on every shard;
- embed sharding swaps the step for the split step
  (:mod:`.shard`): each rank uploads its byte columns of each shard,
  padded once when staged, holds ``[G/R, H]`` of the embedding, and
  allreduces the hidden activations once a step on the host
  (``h_step``; the ``embed_allreduce`` seam fires before it, with the
  step count as its epoch) and once an eval (``h_eval``). At bf16 the
  split forward and backward are the packed kernels at the local width.

At one rank both axes run exactly the code above (byte-identity). Sharded
runs take no checkpoint and no device walker.

The edge partition (``edge_ctx``, a
:class:`~g2vec_tpu_torch.parallel.shard.EdgeContext`, at more than one
rank and with graph sharding) turns the graph-sharded producer's walk
into a collective, as ``g2vec_tpu/train/stream.py:717-745`` does: each
rank holds only its gene range's CSR rows (and the halo's), every rank
joins :func:`~g2vec_tpu_torch.parallel.shard.run_edge_walk` for every
shard and group, and the shard's owner publishes the assembled rows over
the same ``walk/{si}`` exchange, so nothing downstream changes and the
rows are the whole CSR's bytes. A spooled shard that fails verification
cannot be re-walked by one rank there: the run raises
:class:`SpoolIntegrityError` instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import shutil
import tempfile
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from g2vec_tpu_torch.device import resolve_device
from g2vec_tpu_torch.models.cbow import (CBOW, accuracy_from_logits,
                                         init_params, masked_bce_loss,
                                         output_logits, torch_dtype)
from g2vec_tpu_torch.ops.device_walker import (upload_csr,
                                               walk_shard_device_arrays)
from g2vec_tpu_torch.ops.host_walker import (edges_to_csr, plan_shards,
                                             walk_shard)
from g2vec_tpu_torch.ops.packed_matmul import (packed_matmul,
                                               padded_row_bytes, unpack_bits)
from g2vec_tpu_torch.parallel.shard import subset_starts
from g2vec_tpu_torch.resilience.faults import fault_point
from g2vec_tpu_torch.resilience.lifecycle import DrainRequested
from g2vec_tpu_torch.train.checkpoint import (RUN_COMPLETED,
                                              RUN_EARLY_STOPPED,
                                              RUN_IN_PROGRESS, N_LEAVES,
                                              flatten_state,
                                              load_stream_state,
                                              save_stream_state,
                                              unflatten_state)
from g2vec_tpu_torch.train.trainer import (TrainResult, _Adam,
                                           check_finite, check_gradients)
from g2vec_tpu_torch.utils.integrity import sha256_file


_STATS_LOCK = threading.Lock()
_TOTALS: Dict[str, float] = {}


def _record_totals(**fields) -> None:
    """Add one run's counters to the process-wide totals: ``last_*``
    fields replace, ``max_*`` fields keep the largest, the rest add."""
    with _STATS_LOCK:
        _TOTALS["runs"] = _TOTALS.get("runs", 0) + 1
        for k, v in fields.items():
            if k.startswith("last_"):
                _TOTALS[k] = v
            elif k.startswith("max_"):
                _TOTALS[k] = max(_TOTALS.get(k, 0), v)
            else:
                _TOTALS[k] = _TOTALS.get(k, 0) + v


def stream_stats() -> Dict[str, float]:
    """Every streaming run's counters since the process started (empty
    until the first run)."""
    with _STATS_LOCK:
        return dict(_TOTALS)


@dataclasses.dataclass
class Shard:
    """One in-flight walk shard: group-g rows then group-p rows, in the
    walker's np.packbits layout (8 genes a byte)."""

    index: int
    x: np.ndarray            # [rows, ceil(G/8)] uint8
    y: np.ndarray            # [rows] int32 labels (0 good, 1 poor)

    @property
    def nbytes(self) -> int:
        return self.x.nbytes + self.y.nbytes


class ShardRing:
    """Bounded producer->consumer shard queue with explicit failure edges.

    - full ring: ``put`` blocks (backpressure: the sampler cannot run
      ahead of the trainer by more than ``depth`` shards);
    - producer failure: ``fail(exc)`` parks the exception; the consumer's
      next ``get`` re-raises it;
    - producer done: ``finish``; ``get`` returns None once drained;
    - consumer gone: ``cancel`` wakes a blocked producer, whose ``put``
      returns False (the producer then exits instead of wedging the
      overlap drain, which runs ``cancel`` as a closer).
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        self._items: deque = deque()            # guarded-by: _cv
        self._cv = threading.Condition()
        self._error: Optional[BaseException] = None    # guarded-by: _cv
        self._finished = False                  # guarded-by: _cv
        self._cancelled = False                 # guarded-by: _cv
        # Accounting (read after the run; the lock covers writes).
        self.occupancy_hw = 0        # guarded-by: _cv — max shards resident
        self.peak_bytes = 0          # guarded-by: _cv — max bytes resident
        self.shards_put = 0          # guarded-by: _cv
        self.wait_put_s = 0.0        # guarded-by: _cv — blocked on full ring
        self.wait_get_s = 0.0        # guarded-by: _cv — blocked on empty one

    def put(self, shard: Shard) -> bool:
        """Enqueue; blocks while full. False: the ring was cancelled
        (consumer gone) and the producer should stop."""
        t0 = time.perf_counter()
        with self._cv:
            while len(self._items) >= self.depth and not self._cancelled:
                self._cv.wait(timeout=0.1)
            self.wait_put_s += time.perf_counter() - t0
            if self._cancelled:
                return False
            self._items.append(shard)
            self.shards_put += 1
            self.occupancy_hw = max(self.occupancy_hw, len(self._items))
            self.peak_bytes = max(self.peak_bytes,
                                  sum(s.nbytes for s in self._items))
            self._cv.notify_all()
        return True

    @property
    def cancelled(self) -> bool:
        with self._cv:
            return self._cancelled

    def get(self) -> Optional[Shard]:
        """Dequeue the next shard (emission order); blocks while empty.
        None: the producer finished and the queue is drained. A producer
        failure re-raises here."""
        t0 = time.perf_counter()
        with self._cv:
            while True:
                if self._error is not None:
                    self.wait_get_s += time.perf_counter() - t0
                    raise self._error
                if self._items:
                    self.wait_get_s += time.perf_counter() - t0
                    shard = self._items.popleft()
                    self._cv.notify_all()
                    return shard
                if self._finished or self._cancelled:
                    self.wait_get_s += time.perf_counter() - t0
                    return None
                self._cv.wait(timeout=0.1)

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            self._error = exc
            self._cv.notify_all()

    def finish(self) -> None:
        with self._cv:
            self._finished = True
            self._cv.notify_all()

    def cancel(self) -> None:
        """Consumer-side teardown: unblock and stop the producer.
        Idempotent and safe after finish()."""
        with self._cv:
            self._cancelled = True
            self._items.clear()
            self._cv.notify_all()


class SpoolIntegrityError(ValueError):
    """A spooled shard failed sha256 verification and its deterministic
    re-walk did not reproduce the recorded bytes: the walk inputs changed
    under the run."""


class SpoolWriteError(RuntimeError):
    """A shard failed to spool (ENOSPC, EIO, a short write): the stream
    cannot replay epochs without its spool."""

    def __init__(self, index: int, path: str, detail: str):
        self.index, self.path = index, path
        super().__init__(f"failed to spool shard {index} to {path}: "
                         f"{detail}; the streaming run cannot replay "
                         f"epochs without its spool")


def _spool_write(index: int, path: str, arr: np.ndarray) -> None:
    """np.save with its failure modes named: an OSError and a silent short
    write both raise :class:`SpoolWriteError`."""
    try:
        np.save(path, arr)
        size = os.path.getsize(path)
    except OSError as e:
        with contextlib.suppress(OSError):
            os.unlink(path)
        raise SpoolWriteError(index, path, f"{type(e).__name__}: {e}") from e
    if size < arr.nbytes:        # .npy = header + raw bytes, so >= nbytes
        with contextlib.suppress(OSError):
            os.unlink(path)
        raise SpoolWriteError(index, path, f"short write ({size} bytes on "
                              f"disk < {arr.nbytes} data bytes)")


class ShardSpool:
    """Disk spool of the epoch-0 shard stream, replayed by epochs 1..N.

    One ``.npy`` per shard under a run-private directory, its sha256
    recorded at emission. A replay whose bytes mismatch is re-walked once
    through the deterministic sampler; the re-walk must reproduce the
    recorded hash, else :class:`SpoolIntegrityError`.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._sha: Dict[int, str] = {}
        self.rewalks = 0

    def x_path(self, index: int) -> str:
        return os.path.join(self.directory, f"shard{index:06d}_x.npy")

    def save(self, shard: Shard) -> str:
        path = self.x_path(shard.index)
        _spool_write(shard.index, path, shard.x)
        self._sha[shard.index] = sha256_file(path)
        return path

    def load(self, index: int,
             rewalk: Callable[[int], np.ndarray]) -> np.ndarray:
        """Shard ``index``'s verified rows (its labels are a function of
        the plan alone)."""
        path = self.x_path(index)
        want = self._sha[index]
        if sha256_file(path) != want:
            warnings.warn(
                f"spooled shard {index} failed sha256 verification "
                f"({path}); re-walking it through the deterministic "
                f"sampler", RuntimeWarning)
            self.rewalks += 1
            _spool_write(index, path, rewalk(index))
            if sha256_file(path) != want:
                raise SpoolIntegrityError(
                    f"shard {index}: the deterministic re-walk does not "
                    f"reproduce the bytes recorded at emission; the walk "
                    f"inputs changed under the run")
        return np.load(path)


@dataclasses.dataclass
class StreamStats:
    """One streaming run's attribution record (the ``stream`` metrics
    event and the ``train`` stage's extras)."""

    n_shards: int = 0
    shards_emitted: int = 0
    n_paths: int = 0                 # rows trained on (after the per-shard
                                     # common-drop/dedup)
    rows_sampled: int = 0            # raw walker rows (2 x walkers)
    shard_rows: int = 0
    ring_depth: int = 0
    ring_occupancy_hw: int = 0
    ring_peak_bytes: int = 0
    prefetch_wait_ms: float = 0.0
    time_to_first_update_ms: float = 0.0
    shards_at_first_update: int = 0
    sampling_wall_s: float = 0.0
    producer_blocked_s: float = 0.0
    rewalks: int = 0
    epochs: int = 0
    checkpoints: int = 0             # cursor checkpoints written this run
    checkpoint_wall_s: float = 0.0   # wall spent inside save_stream_state
    resumed: int = 0                 # 1 = this run restored a cursor
    feed_mode: str = "ring"          # "ring": shards cross the host ring and
                                     # are uploaded a step at a time;
                                     # "device": epoch 0 walks and trains
                                     # on the card (the device walker)
    h2d_bytes_saved: int = 0         # packed training bytes the device feed
                                     # kept from crossing host to card
    device_recomputes: int = 0       # device walks relaunched after a
                                     # fault (the device_walk seam)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StreamTrainResult:
    train: TrainResult
    gene_freq: Dict[str, int]        # the streaming count_gene_freq twin
    n_paths: int
    stats: StreamStats


def _check_group_edges(src: np.ndarray, dst: np.ndarray, n_genes: int):
    for name, arr in (("src", src), ("dst", dst)):
        if arr.size and (arr.min() < 0 or arr.max() >= n_genes):
            raise ValueError(
                f"{name} contains node ids outside [0, {n_genes})")


def _shard_split(rows: int, seed: int, shard_index: int,
                 val_fraction: float):
    """The per-shard held-out split: the full-batch shuffled hold-out
    applied per shard, seeded by (train seed, shard index), so it does not
    depend on thread count or ring depth. Each side keeps a row."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, shard_index)))
    perm = rng.permutation(rows)
    pivot = int(rows * (1.0 - val_fraction))
    pivot = max(1, min(pivot, rows - 1))
    return perm[:pivot], perm[pivot:]


def _filter_rows(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``integrate_path_sets`` at shard granularity: drop rows whose bytes
    appear in both groups' blocks of this shard, and keep one copy per
    group of within-shard duplicates. Returns the kept row indices, in
    order. (Walker i starts at the same gene in both groups, so the
    degenerate common paths line up inside one shard.)"""
    row_bytes = [r.tobytes() for r in x]
    g_set = {b for b, label in zip(row_bytes, y) if label == 0}
    common = g_set & {b for b, label in zip(row_bytes, y) if label == 1}
    seen = (set(), set())
    keep = []
    for i, (b, label) in enumerate(zip(row_bytes, y)):
        if b in common or b in seen[label]:
            continue
        seen[label].add(b)
        keep.append(i)
    return np.asarray(keep, dtype=np.int64)


#: Bounded eval buffers: the val (and train-probe) sets gather per-shard
#: held-out rows in shard order up to this many rows, so the epoch-end
#: eval stays O(1) in graph size.
EVAL_ROWS_CAP = 4096


class _Resident:
    """A shard's train rows already on the training device (the device
    feed): ``x`` in :class:`_Batch`'s padded layout, labels ``y``."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor):
        self.x, self.y = x, y

    def ready(self):
        return self.x, self.y


class _Batch:
    """A shard's train rows on the training device: packed rows ``x``
    (each padded to the kernels' row stride), labels ``y [n, 1]``, and on
    the card the event of their side-stream copy."""

    def __init__(self, x: np.ndarray, y: np.ndarray, n_genes: int,
                 dev: torch.device, copy_stream):
        n, nb = x.shape
        nbp = padded_row_bytes(n_genes)
        pin = dev.type == "cuda"
        x_host = torch.empty((n, nbp), dtype=torch.uint8, pin_memory=pin)
        xv = x_host.numpy()
        xv[:, :nb] = x
        xv[:, nb:] = 0
        y_host = torch.from_numpy(y.astype(np.float32)[:, None])
        self.event = None
        if pin:
            y_host = y_host.pin_memory()
            with torch.cuda.stream(copy_stream):
                self.x = x_host.to(dev, non_blocking=True)
                self.y = y_host.to(dev, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(copy_stream)
        else:
            self.x, self.y = x_host, y_host

    def ready(self):
        """(x, y) for the current stream: waits on the copy, and marks
        the tensors used there, so that the allocator does not hand their
        memory back to the copy stream while a step still reads them."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.x.device)
            stream.wait_event(self.event)
            self.x.record_stream(stream)
            self.y.record_stream(stream)
        return self.x, self.y


def _loss_values(prefix: List[float], losses: List[torch.Tensor]
                 ) -> np.ndarray:
    """The epoch's per-shard losses as float64 (a resumed epoch's restored
    prefix, then this run's), in one copy from the device."""
    tail = (torch.stack(losses).cpu().numpy().astype(np.float64)
            if losses else np.zeros(0, np.float64))
    return np.concatenate([np.asarray(prefix, np.float64), tail])


def train_cbow_streaming(
        *, groups, n_genes: int, genes, hidden: int, learning_rate: float,
        max_epochs: int, len_path: int, reps: int, val_fraction: float = 0.2,
        decision_threshold: float = 0.5, compute_dtype: str = "bfloat16",
        param_dtype: str = "float32", seed: int = 0, walk_seed: int = 0,
        shard_paths: int = 0, prefetch_depth: int = 2, patience: int = 5,
        sampler_threads: int = 0, overlap=None,
        walker_backend: str = "native",
        eval_rows_cap: int = EVAL_ROWS_CAP, device="cuda",
        init: Optional[CBOW] = None,
        on_epoch: Optional[Callable[[int, float, float, float], None]] = None,
        checkpoint_dir: Optional[str] = None, resume: bool = False,
        checkpoint_every: int = 25,
        console: Callable[[str], None] = print,
        check: Optional[Callable[[], None]] = None,
        lifecycle: Optional[Callable[[str, dict], None]] = None,
        debug_nans: bool = False, shard_ctx=None, walk_starts: int = 0,
        edge_ctx=None) -> StreamTrainResult:
    """Stream walk shards from the sampler straight into minibatch SGD;
    returns the trained embeddings and the streaming twins of stage 3's
    byproducts (gene votes, path count).

    ``groups`` is ``[(src_g, dst_g, w_g), (src_p, dst_p, w_p)]``, the two
    thresholded per-group edge lists. ``overlap`` is the pipeline's
    :class:`~g2vec_tpu_torch.parallel.overlap.OverlapScheduler`: the
    producer runs on it under its drain contract (None: a thread of its
    own). ``seed`` is the split/init seed, ``walk_seed`` the walk seed.
    ``walker_backend`` is "native" (the C++ sampler feeding the ring) or
    "device" (the walker kernel on ``device``, fused into epoch 0: module
    docstring).
    ``init`` replaces the seeded draw of the CBOW (the tests pass the JAX
    package's draw through :func:`g2vec_tpu_torch.weights.params_from_jax`).
    ``on_epoch(step, acc_val, acc_tr, secs)`` fires every epoch.
    ``checkpoint_dir`` turns on the cursor checkpoint every
    ``checkpoint_every`` shard updates and at every epoch boundary;
    ``resume=True`` restores the newest verified cursor (module
    docstring). ``console`` prints the resume line. ``check`` and
    ``lifecycle``: module docstring. ``debug_nans``: as
    :func:`~g2vec_tpu_torch.train.trainer.train_cbow`'s, per shard update.
    ``shard_ctx``, ``walk_starts`` and ``edge_ctx``: module docstring.
    Under an embed
    split the result's ``w_ih`` holds this rank's gene rows only
    (``[g_local, H]``), and ``init`` is the full ``[G, H]`` init, of which
    the rank takes its slice.
    """
    dev = resolve_device(device)
    if len(groups) != 2:
        raise ValueError(f"need exactly 2 groups, got {len(groups)}")
    torch_dtype(compute_dtype)
    pdtype = torch_dtype(param_dtype)
    if patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    if eval_rows_cap < 1:
        raise ValueError(f"eval_rows_cap must be >= 1, got {eval_rows_cap}")
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if walker_backend not in ("native", "device"):
        raise ValueError(
            f"walker_backend must be native|device, got {walker_backend!r}")

    # ---- sharding axes ----
    spec = shard_ctx.spec if shard_ctx is not None else None
    graph_multi = bool(spec and spec.graph_shards and spec.n_ranks > 1)
    embed_multi = bool(spec and spec.embed_split)
    if (graph_multi or embed_multi) and (checkpoint_dir or resume):
        raise ValueError(
            "sharded streaming (--graph-shards/--embed-shards at >1 "
            "process) does not compose with checkpoint/resume yet — the "
            "cursor would have to be a consistent distributed snapshot")
    if spec is not None and spec.n_genes != n_genes:
        raise ValueError(
            f"shard context was built for {spec.n_genes} genes, trainer "
            f"got {n_genes}")
    edge_multi = edge_ctx is not None
    if edge_multi and not graph_multi:
        raise ValueError(
            "edge_ctx (multi-rank --edge-partition) rides the "
            "graph-sharded producer's shard exchange; pass a multi-rank "
            "graph-sharded shard_ctx or None")
    if walker_backend == "device" and (graph_multi or embed_multi):
        raise ValueError(
            "the device walker does not compose with sharded streaming "
            "yet — those producers exchange shards over host transports "
            "keyed to the native pool")

    starts = subset_starts(n_genes, walk_starts)
    n_starts = n_genes if starts is None else len(starts)
    plan = plan_shards(n_starts, reps, shard_paths, len_path=len_path)
    n_shards = plan.n_shards
    stats = StreamStats(n_shards=n_shards, rows_sampled=2 * plan.n_walkers,
                        shard_rows=plan.rows_per_shard,
                        ring_depth=prefetch_depth)
    if edge_multi:
        # The rank's partial per-group CSRs, built (and in halo mode
        # halo-merged) by the pipeline: the groups' edges cover only the
        # owned gene range, so no full-width CSR is built from them.
        csr = [p.csr for p in edge_ctx.pcsrs]
    else:
        csr = []
        for s, d, w in groups:
            s, d, w = np.asarray(s), np.asarray(d), np.asarray(w)
            _check_group_edges(s, d, n_genes)
            csr.append(edges_to_csr(s, d, w, n_genes))

    # The device walker reads each group's CSR from the card, uploaded
    # once.
    device_feed = walker_backend == "device"
    csr_dev = ([upload_csr(c, n_genes, dev) for c in csr]
               if device_feed else None)

    def _device_walk_group(gi: int, shard_index: int):
        """One group's rows of a shard on the card, packed, left there.
        A failed walk is relaunched once on the same kernel: the walk is
        a function of (plan, shard, seed), so the rows are the same."""
        for attempt in (0, 1):
            try:
                return walk_shard_device_arrays(
                    None, None, None, n_genes, plan, shard_index,
                    seed=(walk_seed << 1) | gi, csr=csr_dev[gi],
                    starts=starts)[0]
            except Exception:
                if attempt:
                    raise
                stats.device_recomputes += 1

    def _walk_shard_rows(shard_index: int) -> np.ndarray:
        if walker_backend == "native":
            return np.concatenate([
                walk_shard(None, None, None, n_genes, plan, shard_index,
                           seed=(walk_seed << 1) | gi,
                           n_threads=sampler_threads, csr=csr[gi],
                           starts=starts)
                for gi in (0, 1)], axis=0)
        return torch.cat([_device_walk_group(gi, shard_index)
                          for gi in (0, 1)]).cpu().numpy()

    def _rewalk(shard_index: int) -> np.ndarray:
        """The spool's re-walk of a shard that failed verification. An
        edge-partitioned rank holds part of the CSR and the collective has
        moved on, so there the failure is final."""
        if edge_multi:
            raise SpoolIntegrityError(
                f"shard {shard_index}: spooled bytes failed verification "
                "and this rank holds only a partial CSR under "
                "--edge-partition; re-walking needs the whole fleet — "
                "restart the run")
        return _walk_shard_rows(shard_index)

    def _shard_labels(shard_index: int) -> np.ndarray:
        n = plan.group_rows(shard_index)
        return np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])

    ring = ShardRing(prefetch_depth)
    if checkpoint_dir:
        # Durable spool: the replay epochs and a resume read it, so it
        # lives with the cursor and outlives the process; whoever owns
        # checkpoint_dir removes it.
        spool_dir = os.path.join(os.path.abspath(checkpoint_dir), "spool")
        os.makedirs(spool_dir, exist_ok=True)
    else:
        spool_dir = tempfile.mkdtemp(prefix="g2v-stream-")
    spool = ShardSpool(spool_dir)

    fingerprint = {
        "hidden": hidden, "learning_rate": learning_rate,
        "compute_dtype": compute_dtype, "param_dtype": param_dtype,
        "seed": seed, "walk_seed": walk_seed,
        "val_fraction": val_fraction,
        "decision_threshold": decision_threshold,
        "n_genes": n_genes, "len_path": len_path, "reps": reps,
        "n_shards": n_shards, "rows_per_shard": plan.rows_per_shard,
        "patience": patience, "eval_rows_cap": eval_rows_cap,
        "max_epochs": max_epochs, "walk_starts": walk_starts,
    }
    # ---- resume: the newest verified cursor, read before the producer
    # starts: it decides where (and whether) sampling restarts ----
    resume_arrays = resume_cursor = None
    if checkpoint_dir and resume:
        loaded = load_stream_state(checkpoint_dir, fingerprint=fingerprint)
        if loaded is not None:
            resume_arrays, resume_cursor = loaded
            spool._sha = {int(k): v for k, v in
                          resume_cursor.get("spool_sha", {}).items()}
            stats.resumed = 1
    start_epoch = int(resume_cursor["epoch"]) if resume_cursor else 0
    start_shard = int(resume_cursor["shard"]) if resume_cursor else 0
    resume_done = (int(resume_cursor.get("done", RUN_IN_PROGRESS))
                   if resume_cursor else RUN_IN_PROGRESS)
    producer_wall = [0.0]

    # Under the device feed one writer thread saves each shard while the
    # step trains on its resident copy; _drain_spool joins the writes
    # before a cursor cut, before the replay reads them and at teardown.
    stats.feed_mode = "device" if device_feed else "ring"
    spool_futs: Dict[int, object] = {}
    spool_pool = (ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="g2v-spool")
                  if device_feed else None)

    def _spool_async(shard: Shard) -> None:
        spool_futs[shard.index] = spool_pool.submit(spool.save, shard)

    def _drain_spool() -> None:
        for si in sorted(spool_futs):
            spool_futs.pop(si).result()

    def _publish_rows(si: int, rows: np.ndarray, owner: int) -> None:
        from g2vec_tpu_torch.parallel import hostcomm

        buf = io.BytesIO()
        np.save(buf, rows, allow_pickle=False)
        hostcomm.exchange_bytes(f"walk/{si}", buf.getvalue(), owner)

    def _recv_exchanged_rows(si: int, owner: int) -> Optional[np.ndarray]:
        """The receiving side of ``walk/{si}``: waits in slices of at most
        2 s, looking at the ring between them, so that a rank whose
        trainer already stopped returns None instead of waiting out the
        deadline on a publish that may never come."""
        from g2vec_tpu_torch.parallel import hostcomm

        budget = shard_ctx.deadline or hostcomm.DEFAULT_DEADLINE_S
        t_end = time.monotonic() + budget
        while True:
            left = t_end - time.monotonic()
            if left <= 0:
                # The transport's own naming of the owner that never
                # published.
                return np.load(io.BytesIO(hostcomm.exchange_bytes(
                    f"walk/{si}", None, owner, deadline=1e-3)),
                    allow_pickle=False)
            try:
                raw = hostcomm.exchange_bytes(f"walk/{si}", None, owner,
                                              deadline=min(2.0, left))
                return np.load(io.BytesIO(raw), allow_pickle=False)
            except hostcomm.PeerTimeoutError:
                if ring.cancelled:
                    return None

    def _exchange_rows(si: int, owner: int) -> Optional[np.ndarray]:
        """Shard ``si`` under graph sharding: its owner walks and
        publishes it (on this producer thread, so under an explicit key),
        the others receive it."""
        if owner == spec.rank:
            rows = _walk_shard_rows(si)
            # The dead owner's seam: a sigkill here leaves the peers'
            # reads waiting until their deadline names this rank.
            fault_point("shard_exchange", epoch=si)
            _publish_rows(si, rows, owner)
            return rows
        return _recv_exchanged_rows(si, owner)

    def _edge_rows(si: int, owner: int) -> Optional[np.ndarray]:
        """Shard ``si`` under the edge partition: every rank joins the
        collective walk of each group (partial walks on its rows, the
        suspended states handed to the ranks holding their rows, one
        termination round; explicit keys, so safe on this thread), then
        the owner publishes the assembled rows over ``walk/{si}`` as
        :func:`_exchange_rows` does."""
        from g2vec_tpu_torch.parallel.shard import run_edge_walk

        parts = []
        for gi in (0, 1):
            rows_g = run_edge_walk(
                edge_ctx.pcsrs[gi], plan, si,
                seed=(walk_seed << 1) | gi, owner=owner,
                rank=spec.rank, n_ranks=spec.n_ranks, starts=starts,
                n_threads=sampler_threads, deadline=shard_ctx.deadline,
                key_prefix=f"edgewalk/g{gi}",
                cancelled=lambda: ring.cancelled, stats=edge_ctx.stats)
            if rows_g is None and spec.rank == owner:
                return None          # the consumer is gone
            parts.append(rows_g)
        if owner == spec.rank:
            rows = np.concatenate(parts, axis=0)
            fault_point("shard_exchange", epoch=si)
            _publish_rows(si, rows, owner)
            return rows
        return _recv_exchanged_rows(si, owner)

    def _produce():
        t0 = time.perf_counter()
        try:
            for si in range(start_shard, n_shards):
                if graph_multi:
                    owner = spec.shard_owner(si, n_shards)
                    rows = (_edge_rows(si, owner) if edge_multi
                            else _exchange_rows(si, owner))
                    if rows is None:
                        return      # consumer gone while waiting
                else:
                    rows = _walk_shard_rows(si)
                shard = Shard(si, rows, _shard_labels(si))
                path = spool.save(shard)
                # The in-flight shard's seam: corrupt tears the spooled
                # bytes (epoch 0 trains on the good copy in memory; the
                # replay's verification catches them); the other kinds
                # surface at the consumer's next get through ring.fail.
                fault_point("shard_ring", epoch=si, path=path)
                if not ring.put(shard):
                    return          # consumer gone; exit quietly
            ring.finish()
        except BaseException as e:  # noqa: BLE001 — the consumer re-raises
            ring.fail(e)
        finally:
            producer_wall[0] = time.perf_counter() - t0

    # The producer samples only epoch 0's remaining shards: a resume at
    # epoch >= 1 (or at a terminal cursor) replays the spool, and the
    # device feed walks in the training loop.
    remove_closer = producer_thread = None
    if resume_done == RUN_IN_PROGRESS and start_epoch == 0 \
            and not device_feed:
        if overlap is not None:
            remove_closer = overlap.add_closer(ring.cancel)
            overlap.submit("stream_shards", _produce)
        else:
            producer_thread = threading.Thread(
                target=_produce, name="g2v-stream-producer", daemon=True)
            producer_thread.start()

    # ---- parameters, optimizer, device programs ----
    if init is None:
        init = init_params(n_genes, hidden, torch.Generator().manual_seed(seed))
    if tuple(init.w_ih.shape) != (n_genes, hidden):
        raise ValueError(f"init w_ih {tuple(init.w_ih.shape)} vs "
                         f"({n_genes}, {hidden})")
    # The width of the rows a step reads and of W_ih: under an embed split
    # the rank's byte columns and its slice of the table, padded to whole
    # bytes with zero rows (walks set no bit past G, so the pad rows get
    # no gradient and stay zero).
    x_genes = n_genes
    if embed_multi:
        from g2vec_tpu_torch.train.shard import make_split_fns, split_params

        blo, bhi = spec.byte_range()
        x_genes = (bhi - blo) * 8
        init = split_params(init, spec)
        split = make_split_fns(compute_dtype, decision_threshold, x_genes)
    model = CBOW(init.w_ih.detach().to(device=dev, dtype=pdtype).clone(),
                 init.w_ho.detach().to(device=dev, dtype=pdtype).clone())
    params = [model.w_ih, model.w_ho]
    adam = _Adam(params, learning_rate)
    snapshot = [p.detach().clone() for p in params]
    if resume_arrays is not None:
        # The fingerprint (hidden, n_genes, param_dtype) fixed the leaves'
        # shapes and dtypes when the cursor was loaded.
        w_params, opt_state, w_snap = unflatten_state(
            [torch.as_tensor(resume_arrays[f"leaf_{i}"])
             for i in range(N_LEAVES)])
        with torch.no_grad():
            for p, w in zip(params, w_params):
                p.copy_(w)
        adam.load(opt_state, dev)
        snapshot = [w.to(dev) for w in w_snap]
    logit_threshold = float(np.log(decision_threshold
                                   / (1.0 - decision_threshold)))
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def _reduced_hidden(name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial activations, allreduced over the host."""
        h_part = split.partial_hidden(model.w_ih.detach(), x).cpu().numpy()
        return torch.from_numpy(shard_ctx.allreduce(name, h_part)).to(dev)

    step_count = [0]                 # split steps so far (the seam's epoch)

    def _split_update(batch: _Batch) -> torch.Tensor:
        x, y = batch.ready()
        # The mid-step seam: a rank killed here leaves its peers' allreduce
        # waiting until their deadline names it.
        fault_point("embed_allreduce", epoch=step_count[0])
        step_count[0] += 1
        h = _reduced_hidden("h_step", x)
        ones = torch.ones_like(y)
        loss, dw_ho, dh = split.head_grads(model.w_ho, h, y, ones)
        if debug_nans:
            check_finite(loss, "loss (masked_bce_loss) of a shard update")
        model.w_ih.grad = split.embed_grad(x, dh).to(pdtype)
        model.w_ho.grad = dw_ho.to(pdtype)
        if debug_nans:
            check_gradients(params, "after a shard update")
        adam.step(params)
        return loss

    def _logits(x: torch.Tensor) -> torch.Tensor:
        if compute_dtype == "float32":
            return model(unpack_bits(x, n_genes, torch.float32), "float32")
        h = packed_matmul(x, model.w_ih.to(torch.bfloat16))
        return output_logits(h, model.w_ho, compute_dtype)

    def _update(batch: _Batch) -> torch.Tensor:
        if embed_multi:
            return _split_update(batch)
        x, y = batch.ready()
        loss = masked_bce_loss(_logits(x), y, torch.ones_like(y))
        if debug_nans:
            check_finite(loss, "loss (masked_bce_loss) of a shard update")
        loss.backward()
        if debug_nans:
            check_gradients(params, "after a shard update")
        adam.step(params)
        return loss.detach()

    @torch.no_grad()
    def _evaluate(batch: _Batch) -> float:
        x, y = batch.ready()
        if embed_multi:
            return float(split.head_eval(model.w_ho,
                                         _reduced_hidden("h_eval", x), y,
                                         torch.ones_like(y)))
        return float(accuracy_from_logits(_logits(x), y, torch.ones_like(y),
                                          logit_threshold))

    def _upload(x: np.ndarray, y: np.ndarray) -> _Batch:
        if embed_multi:
            x = x[:, blo:bhi]     # copied, padded, once: when it is staged
        return _Batch(x, y, x_genes, dev, copy_stream)

    # ---- epoch-0 byproducts, accumulated in shard order ----
    good_counts = np.zeros(n_genes, np.int64)
    poor_counts = np.zeros(n_genes, np.int64)
    val_x: List[np.ndarray] = []
    val_y: List[np.ndarray] = []
    probe_x: List[np.ndarray] = []
    probe_y: List[np.ndarray] = []
    eval_rows = [0, 0]               # collected (val, probe) row counts
    kept_rows = [0]                  # rows surviving the per-shard filter

    # ---- early-stop bookkeeping (restored whole on resume) ----
    history: List[dict] = []
    best_val, best_tr = -1.0, -1.0
    best_epoch = 0
    since_best = 0
    stopped_early = False
    stop_epoch = max_epochs - 1
    losses0: List[float] = []        # a resumed epoch's restored losses
    x_width = (n_genes + 7) // 8
    if resume_arrays is not None:
        good_counts[:] = resume_arrays["good_counts"]
        poor_counts[:] = resume_arrays["poor_counts"]
        val_x.append(resume_arrays["val_x"])
        val_y.append(resume_arrays["val_y"])
        probe_x.append(resume_arrays["probe_x"])
        probe_y.append(resume_arrays["probe_y"])
        sc = resume_arrays["scalars"]
        best_val, best_tr = float(sc[0]), float(sc[1])
        best_epoch, since_best = int(sc[2]), int(sc[3])
        kept_rows[0] = int(sc[4])
        eval_rows[0], eval_rows[1] = int(sc[5]), int(sc[6])
        stopped_early, stop_epoch = bool(sc[7]), int(sc[8])
        history = [{"epoch": int(r[0]), "acc_val": float(r[1]),
                    "acc_tr": float(r[2]), "loss": float(r[3]),
                    "secs": float(r[4])}
                   for r in resume_arrays["history"].reshape(-1, 5)]
        losses0 = [float(x) for x in resume_arrays["losses"]]

    def _accumulate(x: np.ndarray, y: np.ndarray, tr_idx, vl_idx) -> None:
        # Row-chunked unpack: the dense transient stays ~32 MB at any G;
        # int64 sums do not depend on the chunking.
        rows_chunk = max(1, (32 << 20) // max(1, n_genes))
        for i in range(0, x.shape[0], rows_chunk):
            dense = np.unpackbits(x[i:i + rows_chunk], axis=1)[:, :n_genes]
            yc = y[i:i + rows_chunk]
            good_counts[:] += dense[yc == 0].sum(axis=0, dtype=np.int64)
            poor_counts[:] += dense[yc == 1].sum(axis=0, dtype=np.int64)
        if eval_rows[0] < eval_rows_cap and len(vl_idx):
            take = vl_idx[:eval_rows_cap - eval_rows[0]]
            val_x.append(x[take])
            val_y.append(y[take])
            eval_rows[0] += len(take)
        if eval_rows[1] < eval_rows_cap and len(tr_idx):
            take = tr_idx[:eval_rows_cap - eval_rows[1]]
            probe_x.append(x[take])
            probe_y.append(y[take])
            eval_rows[1] += len(take)

    def _epoch0_iter(start: int) -> Iterator[Shard]:
        for expect in range(start, n_shards):
            fault_point("prefetch", epoch=expect)
            shard = ring.get()
            if shard is None:
                raise RuntimeError(
                    f"shard ring closed after {expect}/{n_shards} shards: "
                    f"the producer exited early without failing")
            if shard.index != expect:
                raise RuntimeError(f"shard order violated: got "
                                   f"{shard.index}, expected {expect}")
            yield shard

    def _replay_iter(start: int) -> Iterator[Shard]:
        for si in range(start, n_shards):
            fault_point("prefetch", epoch=si)
            yield Shard(si, spool.load(si, _rewalk),
                        _shard_labels(si))

    def _device_feed(shards: Iterator[Shard], epoch0: bool):
        """The double buffer: shard b+1's copy is queued on the side
        stream before shard b is yielded to the step, so it hides under
        the step's device time. Yields ``(shard index, accumulate_cb,
        batch)``; the epoch-0 byproducts are accumulated when the
        consumer runs the callback, right before the step, so host state
        advances in strict shard order and a cursor cut after shard b's
        update holds shard b's byproducts and no later ones."""
        pending = None
        for shard in shards:
            keep = _filter_rows(shard.x, shard.y)
            if not len(keep):
                continue             # every row was group-common noise
            fx, fy = shard.x[keep], shard.y[keep]
            tr_idx, vl_idx = _shard_split(fx.shape[0], seed, shard.index,
                                          val_fraction)
            acc_cb = None
            if epoch0:
                def acc_cb(fx=fx, fy=fy, tr=tr_idx, vl=vl_idx, k=len(keep)):
                    kept_rows[0] += k
                    _accumulate(fx, fy, tr, vl)
            nxt = (shard.index, acc_cb, _upload(fx[tr_idx], fy[tr_idx]))
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def _feed_x_device(packed_dev: torch.Tensor,
                       row_idx: np.ndarray) -> torch.Tensor:
        """The kept train rows gathered from the resident shard into the
        layout :class:`_Batch` builds on the host: each row padded with
        zero bytes to the kernels' 4-byte stride (a walk sets no bit past
        n_genes, so the bytes are the same)."""
        rows = packed_dev[torch.from_numpy(row_idx).to(dev)]
        x = torch.zeros((rows.shape[0], padded_row_bytes(n_genes)),
                        dtype=torch.uint8, device=dev)
        x[:, :rows.shape[1]] = rows
        stats.h2d_bytes_saved += x.numel()
        return x

    def _device_epoch0_feed(start: int):
        """Epoch 0 under the device feed: each shard walked on the card,
        copied to the host once for the byproducts and the background
        spool write, its train rows consumed where they lie. The same
        double buffer and deferred accumulation as :func:`_device_feed`,
        and the same rows, filter, split and layout bytes."""
        pending = None
        for si in range(start, n_shards):
            fault_point("prefetch", epoch=si)
            t_walk = time.perf_counter()
            packed_dev = torch.cat([_device_walk_group(gi, si)
                                    for gi in (0, 1)])
            rows_np = packed_dev.cpu().numpy()       # one copy a shard
            producer_wall[0] += time.perf_counter() - t_walk
            labels = _shard_labels(si)
            _spool_async(Shard(si, rows_np, labels))
            keep = _filter_rows(rows_np, labels)
            if not len(keep):
                continue             # every row was group-common noise
            fx, fy = rows_np[keep], labels[keep]
            tr_idx, vl_idx = _shard_split(fx.shape[0], seed, si,
                                          val_fraction)

            def acc_cb(fx=fx, fy=fy, tr=tr_idx, vl=vl_idx, k=len(keep)):
                kept_rows[0] += k
                _accumulate(fx, fy, tr, vl)

            y = torch.from_numpy(fy[tr_idx].astype(np.float32)[:, None])
            nxt = (si, acc_cb,
                   _Resident(_feed_x_device(packed_dev, keep[tr_idx]),
                             y.to(dev)))
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def _host_eval_cat():
        """The eval buffers as one host array pair each (empty-safe): the
        bytes a resume needs to rebuild the epoch-boundary eval."""
        if val_x:
            vx, vy = np.concatenate(val_x), np.concatenate(val_y)
        else:
            vx, vy = (np.zeros((0, x_width), np.uint8),
                      np.zeros((0,), np.int32))
        if probe_x:
            px, py = np.concatenate(probe_x), np.concatenate(probe_y)
        else:
            px, py = (np.zeros((0, x_width), np.uint8),
                      np.zeros((0,), np.int32))
        return vx, vy, px, py

    ckpt_count = [0]
    ckpt_wall = [0.0]

    def _save_ckpt(cur_epoch: int, next_shard: int, prefix: List[float],
                   cur_losses: List[torch.Tensor],
                   done: int = RUN_IN_PROGRESS) -> None:
        """Cut the cursor at the current consistent boundary: everything
        the loop owns, keyed to the next shard to train."""
        if not checkpoint_dir:
            return
        if device_feed:
            # A cursor never names spool bytes still in flight on the
            # writer thread: join them first.
            _drain_spool()
        t0 = time.perf_counter()
        arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(
            flatten_state(params, adam.state(), snapshot))}
        vx, vy, px, py = _host_eval_cat()
        arrays.update(
            good_counts=good_counts, poor_counts=poor_counts,
            val_x=vx, val_y=vy, probe_x=px, probe_y=py,
            history=np.array(
                [[h["epoch"], h["acc_val"], h["acc_tr"], h["loss"],
                  h["secs"]] for h in history],
                np.float64).reshape(len(history), 5),
            losses=_loss_values(prefix, cur_losses),
            scalars=np.array(
                [best_val, best_tr, best_epoch, since_best, kept_rows[0],
                 eval_rows[0], eval_rows[1], float(stopped_early),
                 float(stop_epoch)], np.float64))
        cursor = {"epoch": int(cur_epoch), "shard": int(next_shard),
                  "done": int(done), "n_shards": int(n_shards),
                  "spool_sha": {str(k): v
                                for k, v in dict(spool._sha).items()}}
        path = save_stream_state(checkpoint_dir, arrays, cursor,
                                 fingerprint=fingerprint)
        ckpt_count[0] += 1
        ckpt_wall[0] += time.perf_counter() - t0
        if lifecycle is not None:
            lifecycle("checkpointed",
                      {"epoch": int(cur_epoch), "shard": int(next_shard),
                       "done": int(done), "path": path})

    def _checked(cur_epoch: int, next_shard: int, prefix: List[float],
                 cur_losses: List[torch.Tensor]) -> None:
        """Run the cooperative-interruption hook at a consistent
        boundary. A drain cuts a cursor at exactly this point before it
        propagates (the next run resumes here); a cancel or a deadline
        propagates bare: it is terminal, there is nothing to keep."""
        if check is None:
            return
        try:
            check()
        except DrainRequested:
            _save_ckpt(cur_epoch, next_shard, prefix, cur_losses)
            raise

    def _build_result() -> StreamTrainResult:
        stats.n_paths = kept_rows[0]
        stats.epochs = len(history)
        stats.checkpoints = ckpt_count[0]
        stats.checkpoint_wall_s = round(ckpt_wall[0], 3)
        stats.shards_emitted = ring.shards_put
        stats.ring_occupancy_hw = ring.occupancy_hw
        stats.ring_peak_bytes = ring.peak_bytes
        stats.prefetch_wait_ms = round(ring.wait_get_s * 1e3, 2)
        stats.producer_blocked_s = round(ring.wait_put_s, 3)
        stats.sampling_wall_s = round(producer_wall[0], 3)
        stats.rewalks = spool.rewalks
        gene_freq: Dict[str, int] = {}
        for i, g in enumerate(genes):
            fg, fp = int(good_counts[i]), int(poor_counts[i])
            if fg or fp:
                gene_freq[g] = 0 if fg > fp else (1 if fg < fp else 2)
        best = CBOW(*snapshot)
        rows = spec.g_local if embed_multi else n_genes
        train = TrainResult(
            w_ih=best.w_ih.detach()[:rows].float().cpu().numpy(),
            stop_epoch=(best_epoch if stopped_early else stop_epoch),
            stopped_early=stopped_early, acc_val=best_val, acc_tr=best_tr,
            history=history, model=best)
        return StreamTrainResult(train=train, gene_freq=gene_freq,
                                 n_paths=kept_rows[0], stats=stats)

    if resume_done != RUN_IN_PROGRESS:
        # The previous run finished and died before its result was used:
        # the result is rebuilt from the state, with nothing trained.
        if spool_pool is not None:
            spool_pool.shutdown(wait=True)
        if lifecycle is not None:
            lifecycle("resumed", {"epoch": start_epoch, "shard": start_shard,
                                  "done": resume_done})
        _record_totals(epochs=0)
        return _build_result()

    # ---- the epoch loop: patience early stop on held-out val accuracy ----
    val_dev = probe_dev = None
    if resume_cursor is not None:
        console(f"[stream] resuming from cursor epoch {start_epoch} "
                f"shard {start_shard}/{n_shards}")
        if lifecycle is not None:
            lifecycle("resumed", {"epoch": start_epoch, "shard": start_shard,
                                  "done": resume_done})
        if start_epoch > 0:
            # Epoch 0 finished, so the eval buffers are final: rebuild
            # the copies the epoch-boundary eval reads.
            val_dev = _upload(val_x[0], val_y[0])
            probe_dev = _upload(probe_x[0], probe_y[0])
    t_phase0 = time.perf_counter()
    first_update = [True]
    try:
        epoch = start_epoch
        since_ckpt = 0
        while epoch < max_epochs and not stopped_early:
            t_epoch = time.perf_counter()
            resumed_here = resume_cursor is not None and epoch == start_epoch
            offset = start_shard if resumed_here else 0
            prefix = losses0 if resumed_here else []
            losses: List[torch.Tensor] = []
            _checked(epoch, offset, prefix, losses)
            if device_feed and epoch == 0:
                feed = _device_epoch0_feed(offset)
            else:
                if device_feed:
                    _drain_spool()   # the replay reads the spool
                feed = _device_feed(_epoch0_iter(offset) if epoch == 0
                                    else _replay_iter(offset),
                                    epoch0=(epoch == 0))
            for si, acc_cb, batch in feed:
                _checked(epoch, si, prefix, losses)
                if acc_cb is not None:
                    acc_cb()
                losses.append(_update(batch))
                if first_update[0]:
                    first_update[0] = False
                    losses[-1].item()          # wait for the first update
                    stats.time_to_first_update_ms = round(
                        (time.perf_counter() - t_phase0) * 1e3, 2)
                    stats.shards_at_first_update = ring.shards_put
                since_ckpt += 1
                if checkpoint_dir and since_ckpt >= checkpoint_every \
                        and si + 1 < n_shards:
                    _save_ckpt(epoch, si + 1, prefix, losses)
                    since_ckpt = 0
            if epoch == 0:
                if eval_rows[0] == 0:
                    raise ValueError(
                        "streaming val buffer is empty: shards contributed "
                        "no held-out rows (raise --shard-paths or "
                        "val_fraction)")
                # One host array pair each: the eval's copies are made
                # from them, and the cursor cuts save them.
                val_x[:], val_y[:] = ([np.concatenate(val_x)],
                                      [np.concatenate(val_y)])
                probe_x[:], probe_y[:] = ([np.concatenate(probe_x)],
                                          [np.concatenate(probe_y)])
                val_dev = _upload(val_x[0], val_y[0])
                probe_dev = _upload(probe_x[0], probe_y[0])
            acc_val = _evaluate(val_dev)
            acc_tr = _evaluate(probe_dev)
            values = _loss_values(prefix, losses)
            loss_mean = float(np.mean(values)) if len(values) \
                else float("nan")
            secs = time.perf_counter() - t_epoch
            history.append({"epoch": epoch, "acc_val": acc_val,
                            "acc_tr": acc_tr, "loss": loss_mean,
                            "secs": secs})
            if on_epoch is not None:
                on_epoch(epoch, acc_val, acc_tr, secs)
            fault_point("train", epoch=epoch)
            if acc_val > best_val:
                snapshot = [p.detach().clone() for p in params]
                best_val, best_tr = acc_val, acc_tr
                best_epoch = epoch
                since_best = 0
            else:
                since_best += 1
                if since_best >= patience:
                    # The post-best epochs' updates are discarded: the
                    # best epoch's snapshot is the result.
                    stopped_early = True
                    stop_epoch = best_epoch
            epoch += 1
            if checkpoint_dir and not stopped_early and epoch < max_epochs:
                # Epoch-boundary cut: no partial-epoch losses, shard 0.
                _save_ckpt(epoch, 0, [], [])
                since_ckpt = 0
        # Terminal cut: its done code makes a relaunch after a death
        # between here and the result's use rebuild the result from the
        # state instead of training again.
        _save_ckpt(epoch, 0, [], [],
                   done=(RUN_EARLY_STOPPED if stopped_early
                         else RUN_COMPLETED))
    finally:
        ring.cancel()
        if spool_pool is not None:
            # A write error that matters failed the replay or the cut that
            # drained it; an error in flight is the one the caller must
            # see.
            with contextlib.suppress(Exception):
                _drain_spool()
            spool_pool.shutdown(wait=True)
        if remove_closer is not None:
            remove_closer()
        if producer_thread is not None:
            producer_thread.join(timeout=30)
        elif overlap is not None and overlap.has("stream_shards"):
            try:
                overlap.result("stream_shards")
            except BaseException:  # noqa: BLE001 — the real error
                pass               # already surfaced at ring.get()
        if not checkpoint_dir:
            shutil.rmtree(spool_dir, ignore_errors=True)

    result = _build_result()
    _record_totals(shards_emitted=stats.shards_emitted,
                   rewalks=stats.rewalks,
                   max_ring_occupancy_hw=stats.ring_occupancy_hw,
                   max_ring_peak_bytes=stats.ring_peak_bytes,
                   prefetch_wait_ms=stats.prefetch_wait_ms,
                   last_time_to_first_update_ms=(
                       stats.time_to_first_update_ms),
                   epochs=stats.epochs, checkpoints=stats.checkpoints,
                   resumes=stats.resumed)
    return result
