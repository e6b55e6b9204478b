"""The multi-process runtime of the port: who am I, the store, and the
mesh over ranks.

The port's counterpart of ``g2vec_tpu/parallel/distributed.py``'s
``initialize``/``shutdown``/``process_info``/``is_coordinator``/
``host_allgather`` and its mesh half (``cpu_fleet``, ``plan_hybrid_mesh``,
``make_global_mesh``, ``fetch_global``, ``sharded_native_path_set``). The
reference joins the JAX coordination service; the
port needs only what its host collectives ride (:mod:`.hostcomm`): a
``torch.distributed.TCPStore`` that rank 0 hosts at the coordinator
address and every other rank connects to. No process group is made and
nothing crosses ranks on the card, so no NCCL is needed: on one card the
ranks share ``cuda:0``, each with its own CUDA context.

Precedence, as in the reference: argument, then the environment
(``G2VEC_COORDINATOR`` = ``host:port`` of rank 0, ``G2VEC_PROCESS_ID``,
``G2VEC_NUM_PROCESSES``). With nothing given at all, ``initialize``
warns loudly and runs as a single process, queueing a
``single_process_fallback`` event for the metrics stream (a misconfigured
launch would otherwise have every process believe it is rank 0 and write
the same files).

A ``--mesh`` run over R processes takes the reference's ``cpu_fleet()``
form (``g2vec_tpu/pipeline.py:345-366``): the port has no cross-process
device collective, so each rank runs the device stages replicated on a
1x1 local mesh of its one device, only the native walks are split over
the ranks, and the walked rows are allgathered over the store
(:func:`sharded_native_path_set`). :func:`shared_card_fleet` is that
form's predicate.
"""
from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover
    from g2vec_tpu_torch.parallel.mesh import MeshContext

_ENV_COORD = "G2VEC_COORDINATOR"
_ENV_PID = "G2VEC_PROCESS_ID"
_ENV_NPROC = "G2VEC_NUM_PROCESSES"

#: Seconds a rank waits for the store and its peers at start, and the
#: coordinator for its peers' exit at :func:`shutdown`.
JOIN_TIMEOUT_S = 300.0


class _World:
    def __init__(self, rank: int, nproc: int, host: Optional[str] = None,
                 port: int = 0, store=None):
        self.rank, self.nproc = rank, nproc
        self.host, self.port = host, port
        self.store = store                  # the main thread's connection
        self.main = threading.get_ident()
        self.local = threading.local()      # other threads' connections


_world: Optional[_World] = None

# Outcomes of initialize() for the metrics stream, which does not exist
# yet when it runs; pipeline.run drains them.
_pending_events: list = []


def _connect(host: str, port: int, nproc: int, master: bool,
             timeout: float):
    from torch.distributed import TCPStore

    return TCPStore(host, port, nproc, master,
                    timeout=datetime.timedelta(seconds=timeout),
                    wait_for_workers=False)


def initialize(coordinator: Optional[str] = None,
               process_id: Optional[int] = None,
               num_processes: Optional[int] = None) -> None:
    """Join (or, as rank 0, host) the run's store. Idempotent; after
    :func:`shutdown` callable again."""
    global _world
    if _world is not None:
        return
    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if coordinator is None and process_id is None and num_processes is None:
        print("g2vec_tpu_torch: WARNING: --distributed found no coordinator "
              "(no G2VEC_COORDINATOR/PROCESS_ID/NUM_PROCESSES, no "
              "--coordinator/--process-id/--num-processes); running as a "
              "SINGLE process. If this is one process of a multi-process "
              "launch, its peers were NOT found: check the launch flags.",
              file=sys.stderr)
        _pending_events.append({
            "event": "single_process_fallback",
            "reason": "no coordinator: no G2VEC_COORDINATOR/PROCESS_ID/"
                      "NUM_PROCESSES",
            "coordinator": None})
        _world = _World(0, 1)
        return
    nproc = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if nproc < 1 or not 0 <= rank < nproc:
        raise ValueError(f"process id {rank} outside [0, {nproc})")
    if nproc == 1:
        _world = _World(0, 1)
        return
    if not coordinator or ":" not in coordinator:
        raise ValueError(f"a {nproc}-process run needs the coordinator as "
                         f"host:port, got {coordinator!r}")
    host, port = coordinator.rsplit(":", 1)
    store = _connect(host, int(port), nproc, rank == 0, JOIN_TIMEOUT_S)
    _world = _World(rank, nproc, host, int(port), store)
    from g2vec_tpu_torch.parallel import hostcomm

    try:
        hostcomm.barrier("initialize", deadline=JOIN_TIMEOUT_S)
    except BaseException:
        _world = None
        raise


def drain_pending_events() -> list:
    """The queued initialize() events, handed over once."""
    out, _pending_events[:] = list(_pending_events), []
    return out


def shutdown() -> None:
    """Leave the run: each other rank tells rank 0 it is done, and rank 0
    (whose process hosts the store) waits for them before it goes, so no
    peer loses the store mid-read. Safe when never initialized; a peer
    that never says so only costs a warning."""
    global _world
    world, _world = _world, None
    if world is None or world.nproc == 1:
        return
    try:
        if world.rank:
            world.store.set(f"g2vec/exit/{world.rank}", b"")
            world.store.get(f"g2vec/exit/{world.rank}")   # a round trip
        else:
            world.store.wait(
                [f"g2vec/exit/{r}" for r in range(1, world.nproc)],
                datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    except Exception as e:  # noqa: BLE001 — leaving must not fail the run
        import warnings

        warnings.warn(f"distributed shutdown: {e!r}", RuntimeWarning)


def initialized() -> bool:
    return _world is not None


def process_index() -> int:
    return _world.rank if _world is not None else 0


def process_count() -> int:
    return _world.nproc if _world is not None else 1


def thread_store():
    """The calling thread's connection to the store (the main thread's is
    the one made at :func:`initialize`; any other thread gets its own on
    first use), or None in a single-process run."""
    world = _world
    if world is None or world.store is None:
        return None
    if threading.get_ident() == world.main:
        return world.store
    store = getattr(world.local, "store", None)
    if store is None:
        store = _connect(world.host, world.port, world.nproc, False,
                         JOIN_TIMEOUT_S)
        world.local.store = store
    return store


def process_info() -> dict:
    """Who am I in the run: for logs and the metrics stream."""
    import torch

    devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": process_index(),
            "process_count": process_count(),
            "local_devices": devices, "global_devices": devices}


def is_coordinator() -> bool:
    """True on the process that writes the outputs (rank 0)."""
    return process_index() == 0


def host_allgather(name: str, arr, *, deadline: Optional[float] = None):
    """``[nproc, *arr.shape]``: every rank's host array, in rank order.
    COLLECTIVE, over the store, a dead peer named at ``deadline`` (by
    default the fleet's watchdog deadline)."""
    import numpy as np

    from g2vec_tpu_torch.parallel import hostcomm
    from g2vec_tpu_torch.resilience import fleet

    arr = np.asarray(arr)
    if process_count() == 1:
        return arr[None]
    if deadline is None:
        deadline = fleet.config().watchdog_deadline or None
    return hostcomm.allgather_array(name, arr, deadline=deadline)


def shared_card_fleet() -> bool:
    """True in a run of more than one process: the port's counterpart of
    the reference's ``cpu_fleet()`` (``g2vec_tpu/parallel/distributed.py:
    140``). The ranks share this host's card and have no cross-process
    device collective, so a mesh run trains replicated, one 1x1 local
    mesh a rank, and every collective rides the store."""
    return process_count() > 1


def plan_hybrid_mesh(devices, data: int, model: int):
    """The hybrid-mesh factorization of a multi-slice topology: pure
    planning over devices that may carry ``slice_index``.

    One slice (or no slice metadata): None. N > 1 slices:
    ``(per_slice_mesh, dcn_mesh)``, the model axis whole inside a slice
    and the data axis across slices, ``dcn_mesh == (n_slices, 1)``; the
    data axis must divide by the slice count."""
    n_slices = len({getattr(d, "slice_index", 0) for d in devices})
    if n_slices <= 1:
        return None
    if data % n_slices:
        raise ValueError(
            f"data axis {data} must be divisible by the slice count "
            f"{n_slices} so the model axis stays on ICI")
    return (data // n_slices, model), (n_slices, 1)


def make_global_mesh(mesh_shape: Tuple[int, int], device) -> "MeshContext":
    """The ``(data, model)`` context over the fleet's global devices:
    each rank's one local device (the ranks share this host's card, or
    its CPU), rank-major. The shape must multiply to their count; no
    hybrid plan applies (one host, no slices)."""
    import numpy as np
    import torch

    from g2vec_tpu_torch.parallel.mesh import MeshContext

    data, model = mesh_shape
    devices = [torch.device(device)] * process_count()
    if data * model != len(devices):
        raise ValueError(
            f"mesh {tuple(mesh_shape)} needs {data * model} devices; the "
            f"global runtime has {len(devices)} "
            f"(processes: {process_count()})")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return MeshContext(mesh=grid.reshape((data, model)))


def fetch_global(arr):
    """A tensor or array -> host numpy, the same on every rank. In the
    port every rank holds the whole replicated value, so this is a copy
    to the host and no collective; it stands where the reference gathers
    a value sharded over processes."""
    import numpy as np

    if hasattr(arr, "detach"):
        arr = arr.detach().cpu()
        if str(arr.dtype) == "torch.bfloat16":
            arr = arr.float()
        return arr.numpy()
    return np.asarray(arr)


def sharded_native_path_set(src, dst, w, n_genes: int, *, len_path: int,
                            reps: int, seed: int, n_threads: int = 0) -> set:
    """The native walks over the ranks: each samples a contiguous range
    of the flat (repetition x start) walker axis with the global stream
    ids of the single-process call, and three allgathers over the store
    union the packed rows, so every rank returns the single-process
    ``generate_path_set_native`` set byte for byte.

    COLLECTIVE, with the same arguments on every rank. The native
    toolchain is checked across ranks first: a rank that cannot build the
    sampler fails every rank with one error instead of wedging the
    gather. One process: the plain call.
    """
    import numpy as np

    from g2vec_tpu_torch.ops.backend import native_walker_available
    from g2vec_tpu_torch.ops.host_walker import (generate_path_set_native,
                                                 walk_packed_rows)

    nproc = process_count()
    if nproc == 1:
        return generate_path_set_native(src, dst, w, n_genes,
                                        len_path=len_path, reps=reps,
                                        seed=seed, n_threads=n_threads)
    avail = host_allgather(
        "native_avail", np.array([native_walker_available()], dtype=bool))
    if not avail.all():
        missing = [int(p) for p in np.nonzero(~avail.reshape(-1))[0]]
        raise RuntimeError(
            f"walker_backend=native needs the C++ sampler on every host; "
            f"process(es) {missing} cannot build it (no toolchain?). "
            f"Pin --walker-backend device, or fix those hosts.")
    total = n_genes * reps
    per = -(-total // nproc)                      # ceil
    lo = min(process_index() * per, total)
    hi = min(lo + per, total)
    rows = walk_packed_rows(src, dst, w, n_genes, len_path=len_path,
                            reps=reps, seed=seed, n_threads=n_threads,
                            walker_lo=lo, walker_hi=hi)
    padded = np.zeros((per, (n_genes + 7) // 8), dtype=np.uint8)
    padded[:rows.shape[0]] = rows
    counts = host_allgather(
        "native_counts", np.array([rows.shape[0]], dtype=np.int64))
    gathered = host_allgather("native_rows", padded)    # [nproc, per, nb]
    out: set = set()
    for p, n in enumerate(counts.reshape(-1)):
        out.update(row.tobytes() for row in gathered[p, :int(n)])
    return out
