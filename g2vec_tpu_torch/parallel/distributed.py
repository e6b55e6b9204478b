"""The multi-process runtime of the port: who am I, and the store.

The port's counterpart of ``g2vec_tpu/parallel/distributed.py``'s
``initialize``/``shutdown``/``process_info``/``is_coordinator``/
``host_allgather``. The reference joins the JAX coordination service; the
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
"""
from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import Optional

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
    COLLECTIVE, over the store, a dead peer named at ``deadline``."""
    import numpy as np

    from g2vec_tpu_torch.parallel import hostcomm

    arr = np.asarray(arr)
    if process_count() == 1:
        return arr[None]
    return hostcomm.allgather_array(name, arr, deadline=deadline)
