"""Host collectives over a ``torch.distributed.TCPStore``.

The port's copy of ``g2vec_tpu/parallel/hostcomm.py``, whose transport is
the JAX coordination service's key-value store. Here it is the TCPStore
that rank 0 hosts at the coordinator address (:mod:`.distributed`). A
store, not a gloo or NCCL process group, for the reason the reference
gives: values are plain host bytes, every blocking read takes a deadline,
and a missed deadline names exactly which rank never published, so a dead
peer becomes a :class:`PeerTimeoutError` saying "missing rank(s): [1]"
instead of a collective that blocks for ever. Nothing here touches the
card: what crosses ranks (the hidden activations, k-means statistics,
walk shards, the writer's slices) goes through host memory.

Collective contract: every process calls every sequence-numbered helper
(:func:`allgather_bytes`, :func:`allgather_array`, :func:`broadcast_bytes`,
:func:`barrier`) in the same program order, from its main thread. Keys
carry a process-local sequence number, so the order is all that must
agree; a restarted process starts a fresh sequence. A rank deletes its
own published values once an allgather shows that every peer has moved
past them, so the store holds O(one step) of them, not the run's.

The chunked explicit-key helpers (:func:`put_bytes_chunked`,
:func:`get_bytes_chunked`, :func:`exchange_bytes`) draw no sequence
number: the streaming trainer's producer thread exchanges walk shards
under keys such as ``walk/{si}`` while the main thread allreduces, and two
threads drawing from one counter would interleave nondeterministically.
Each thread talks to the store over a connection of its own
(:func:`kv_client`), so a blocking read on one thread never holds up
another's. Payloads travel in chunks of at most :data:`KV_CHUNK_BYTES`,
the count key written last. The store refuses a value over 8 MiB, so the
sequence-numbered collectives frame theirs: a payload up to
:data:`KV_CHUNK_BYTES` inline, a larger one in chunks with a marker set
last (a mesh run's walked rows are ~21 MB a rank at the example).

With the fleet on (:mod:`g2vec_tpu_torch.resilience.fleet`), each
sequence-numbered collective records its (name, seq) in this rank's
liveness file as it enters, and every timeout's message ends with what
the missing ranks' liveness files say: the phase and the last
collective each reached.
"""
from __future__ import annotations

import datetime
import io
import itertools
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from g2vec_tpu_torch.resilience import fleet
# The error's home is the fleet module, as in the reference; callers that
# catch it as ``hostcomm.PeerTimeoutError`` get the same class.
from g2vec_tpu_torch.resilience.fleet import PeerTimeoutError

#: Deadline used when the caller passes 0/None: effectively "block", but
#: still bounded, so that a wedged run surfaces an error at last.
DEFAULT_DEADLINE_S = 7 * 24 * 3600.0

#: Raw payload bytes per store value of the chunked helpers.
KV_CHUNK_BYTES = 2 * 1024 * 1024

_seq = itertools.count()
#: Keys this process published in sequence-numbered collectives and no
#: allgather has shown every peer past yet.
_own_keys: List[str] = []


def kv_client():
    """This thread's connection to the run's store, or None outside an
    initialized multi-process run (:func:`.distributed.initialize`)."""
    from g2vec_tpu_torch.parallel import distributed

    return distributed.thread_store()


def _world():
    from g2vec_tpu_torch.parallel import distributed

    return distributed.process_index(), distributed.process_count()


def _need(client, what: str):
    client = client if client is not None else kv_client()
    if client is None:
        raise RuntimeError(
            f"{what} needs the run's store; was "
            f"g2vec_tpu_torch.parallel.distributed.initialize() skipped?")
    return client


def _is_deadline_error(e: BaseException) -> bool:
    msg = str(e).lower()
    return "timeout" in msg or "timed out" in msg or "deadline" in msg


def _blocking_get(client, key: str, seconds: float) -> bytes:
    """The value under ``key`` once it is there, waiting at most
    ``seconds`` (the store raises on expiry)."""
    client.wait([key], datetime.timedelta(seconds=max(seconds, 1e-3)))
    return client.get(key)


def _left(t_end: float) -> float:
    return t_end - time.monotonic()


def _deadline_end(deadline: Optional[float]) -> Tuple[float, float]:
    budget = deadline if deadline else DEFAULT_DEADLINE_S
    return budget, time.monotonic() + budget


_INLINE, _CHUNKED = b"\x00", b"\x01"


def _publish(client, key: str, payload: bytes) -> List[str]:
    """Set ``key`` to ``payload``: inline up to :data:`KV_CHUNK_BYTES`,
    else in chunks under ``key/x`` with the marker set last. Returns the
    keys written."""
    if len(payload) <= KV_CHUNK_BYTES:
        client.set(key, _INLINE + payload)
        return [key]
    n = put_bytes_chunked(f"{key}/x", payload, client=client)
    client.set(key, _CHUNKED)
    return [key, f"{key}/x/n"] + [f"{key}/x/c{i}" for i in range(n)]


def _fetch(client, key: str, t_end: float) -> bytes:
    """What :func:`_publish` set under ``key``, waiting until ``t_end``
    (the store raises on expiry)."""
    raw = _blocking_get(client, key, _left(t_end))
    if raw[:1] == _INLINE:
        return raw[1:]
    n = int(_blocking_get(client, f"{key}/x/n", _left(t_end)))
    return b"".join(_blocking_get(client, f"{key}/x/c{i}", _left(t_end))
                    for i in range(n))


def _retire_own_keys(client) -> None:
    """Every peer has published the current allgather, so each has read
    all this process published before it: delete those values."""
    for key in _own_keys:
        client.delete_key(key)
    _own_keys.clear()


def allgather_bytes(name: str, payload: bytes, *,
                    deadline: Optional[float] = None) -> List[bytes]:
    """One bytes payload per rank, in rank order, on every rank.
    COLLECTIVE. On deadline expiry raises :class:`PeerTimeoutError`
    naming every rank whose payload never arrived."""
    from g2vec_tpu_torch.resilience.faults import fault_point

    rank, nproc = _world()
    if nproc == 1:
        return [payload]
    # A faulted rank stops before it publishes, so its key stays absent:
    # what its peers then report.
    fault_point("allgather")
    client = _need(None, f"host collective {name!r}")
    seq = next(_seq)
    fleet.note_collective(name, seq)
    key = f"g2vec/ag/{seq}/{name}"
    mine = _publish(client, f"{key}/{rank}", payload)
    budget, t_end = _deadline_end(deadline)
    out: List[Optional[bytes]] = [None] * nproc
    out[rank] = payload
    missing: List[int] = []
    for peer in range(nproc):
        if peer == rank:
            continue
        try:
            out[peer] = _fetch(client, f"{key}/{peer}", t_end)
        except Exception as e:  # noqa: BLE001 — classify, don't swallow
            if not _is_deadline_error(e):
                raise
            missing.append(peer)
    if missing:
        raise PeerTimeoutError(
            f"collective {name!r} (seq {seq}) exceeded its {budget:.1f}s "
            f"deadline; missing rank(s): {missing}"
            f"{fleet.describe_ranks(missing)}",
            collective=name, suspects=tuple(missing))
    _retire_own_keys(client)
    _own_keys.extend(mine)
    return out  # type: ignore[return-value] — no None left past the raise


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _from_npy(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)


def allgather_array(name: str, arr: np.ndarray, *,
                    deadline: Optional[float] = None) -> np.ndarray:
    """The ``[nproc, *arr.shape]`` stack of every rank's array (each rank
    gives one of the same shape and dtype)."""
    parts = allgather_bytes(name, _npy(arr), deadline=deadline)
    return np.stack([_from_npy(p) for p in parts])


def broadcast_bytes(name: str, payload: Optional[bytes], *,
                    deadline: Optional[float] = None) -> bytes:
    """Rank 0 publishes ``payload``; every rank returns it. COLLECTIVE."""
    from g2vec_tpu_torch.resilience.faults import fault_point

    rank, nproc = _world()
    if nproc == 1:
        if payload is None:
            raise ValueError(f"broadcast {name!r}: rank 0 payload is None")
        return payload
    fault_point("allgather")
    client = _need(None, f"host broadcast {name!r}")
    seq = next(_seq)
    fleet.note_collective(name, seq)
    key = f"g2vec/bc/{seq}/{name}"
    if rank == 0:
        if payload is None:
            raise ValueError(f"broadcast {name!r}: rank 0 payload is None")
        _own_keys.extend(_publish(client, key, payload))
        return payload
    budget, t_end = _deadline_end(deadline)
    try:
        return _fetch(client, key, t_end)
    except Exception as e:  # noqa: BLE001
        if not _is_deadline_error(e):
            raise
        raise PeerTimeoutError(
            f"broadcast {name!r} (seq {seq}) exceeded its {budget:.1f}s "
            f"deadline; missing rank(s): [0]{fleet.describe_ranks([0])}",
            collective=name, suspects=(0,)) from e


def barrier(name: str, *, deadline: Optional[float] = None) -> None:
    """Every rank rendezvouses; stragglers are named at the deadline."""
    allgather_bytes(f"barrier/{name}", b"", deadline=deadline)


def put_bytes_chunked(key: str, payload: bytes, *, client=None,
                      chunk_bytes: int = KV_CHUNK_BYTES) -> int:
    """Publish ``payload`` under ``key`` in chunks; returns the chunk
    count. NOT collective: a plain publish under an explicit key."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    client = _need(client, f"put_bytes_chunked({key!r})")
    n = max(1, -(-len(payload) // chunk_bytes))
    for i in range(n):
        client.set(f"{key}/c{i}", payload[i * chunk_bytes:
                                          (i + 1) * chunk_bytes])
    # The count goes last: a reader that sees it finds every chunk there.
    client.set(f"{key}/n", str(n))
    return n


def get_bytes_chunked(key: str, *, deadline: Optional[float] = None,
                      client=None, owner: Optional[int] = None) -> bytes:
    """Blocking read of a payload :func:`put_bytes_chunked` published. On
    deadline expiry raises :class:`PeerTimeoutError` naming ``owner``
    (when given) as the rank that never published."""
    client = _need(client, f"get_bytes_chunked({key!r})")
    budget, t_end = _deadline_end(deadline)
    try:
        n = int(_blocking_get(client, f"{key}/n", _left(t_end)))
        parts = [_blocking_get(client, f"{key}/c{i}", _left(t_end))
                 for i in range(n)]
    except Exception as e:  # noqa: BLE001 — classify, don't swallow
        if not _is_deadline_error(e):
            raise
        who: Sequence[int] = [] if owner is None else [owner]
        raise PeerTimeoutError(
            f"chunked get {key!r} exceeded its {budget:.1f}s deadline; "
            f"missing rank(s): {list(who)}{fleet.describe_ranks(who)}",
            collective=key, suspects=tuple(who)) from e
    return b"".join(parts)


def exchange_bytes(key: str, payload: Optional[bytes], owner: int, *,
                   deadline: Optional[float] = None,
                   chunk_bytes: int = KV_CHUNK_BYTES) -> bytes:
    """Rank ``owner`` publishes ``payload`` under the explicit ``key``;
    every rank returns it; one process: a passthrough. Safe from any
    thread: the key carries all the coordination (callers keep keys unique
    and agree on the owner)."""
    rank, nproc = _world()
    if nproc == 1 or rank == owner:
        if payload is None:
            raise ValueError(f"exchange {key!r}: owner payload is None")
        if nproc > 1:
            put_bytes_chunked(f"g2vec/xc/{key}", payload,
                              chunk_bytes=chunk_bytes)
        return payload
    return get_bytes_chunked(f"g2vec/xc/{key}", deadline=deadline,
                             owner=owner)
