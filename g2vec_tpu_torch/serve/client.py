"""Client for ``g2vec serve`` daemons and routers (CLI, chip smoke, tests).

The port's copy of ``g2vec_tpu/serve/client.py``: it talks the protocol.py JSONL dialect over a UNIX socket path or a TCP
``host:port`` address (:func:`protocol.dial` picks the transport), to
the port's daemon or the JAX package's. The one failure mode worth a
dedicated type: the server dying mid-job (SIGKILL, preemption) closes
the stream without a terminal event — :class:`ServeConnectionLost`
carries the job_id so the caller can fall back to :func:`poll_result`
(filesystem) or :func:`poll_result_net` (the ``result`` op), which read
the durable record that survives the daemon's death.

HA fleets add two layers on top:

- :func:`submit_and_wait` and :func:`poll_result_net` accept a list of
  router addresses (active + standbys) and rotate through it under the
  jittered backoff, so a client survives a router takeover.
- When no router answers at all, the ``degraded_*`` helpers fall back to
  the fleet's published per-replica ``tcp_addr`` files: reads fan out to
  the replicas directly, and keyed submits go to a replica chosen from
  the key. The idempotency key derives the job_id, so a healed router's
  sticky scan reconciles a degraded submit exactly once.

:func:`update_job` (the ``update`` op) streams an incremental update of
a published bundle to its end.
"""
from __future__ import annotations

import glob
import json
import os
import random
import socket
import time
import uuid
import zlib
from typing import Iterator, List, Optional, Sequence, Union

from g2vec_tpu_torch.serve import protocol

#: A serve endpoint: one address, or a rotation list (router + standbys).
Addr = Union[str, Sequence[str]]


def _rotation(socket_path: Addr) -> List[str]:
    """Normalize an address-or-list into a non-empty rotation list."""
    if isinstance(socket_path, (list, tuple)):
        addrs = [a for a in socket_path if a]
        if not addrs:
            raise ValueError("empty address list")
        return list(addrs)
    return [socket_path]


class ServeConnectionLost(RuntimeError):
    """The daemon's stream closed before the job's terminal event."""

    def __init__(self, msg: str, job_id: Optional[str] = None):
        super().__init__(msg)
        self.job_id = job_id


class ServeTimeout(TimeoutError):
    """A client-side wait expired. Always names the job it was waiting
    for — a bare ``socket.timeout`` tells an operator nothing."""

    def __init__(self, msg: str, job_id: Optional[str] = None):
        super().__init__(msg)
        self.job_id = job_id


class ServeShed(RuntimeError):
    """The fleet shed this job at admission (deadline-aware load
    shedding or a tenant rate limit) on every bounded retry.
    Structured: names the ``tenant`` and ``job_id`` the operator needs,
    plus the server's last ``retry_after_s`` advice — the caller can
    honor it on a slower retry loop of its own."""

    def __init__(self, msg: str, tenant: Optional[str] = None,
                 job_id: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.tenant = tenant
        self.job_id = job_id
        self.retry_after_s = retry_after_s


#: Admission rejections that carry ``retry_after_s`` — transient by
#: contract (the server is saying "later", not "never").
_SHED_ERRORS = ("shed", "tenant_quota")


def request(socket_path: str, payload: dict,
            timeout: Optional[float] = None) -> Iterator[dict]:
    """Send one request; yield the server's JSONL events until it closes
    the stream. ``timeout`` bounds each socket read, not the whole job.
    ``socket_path`` may be a UNIX path or ``host:port``."""
    s = protocol.dial(socket_path, timeout=timeout)
    try:
        f = s.makefile("rwb")
        protocol.write_event(f, payload)
        while True:
            ev = protocol.read_event(f)
            if ev is None:
                return
            yield ev
    finally:
        s.close()


#: Terminal stream events (``job_drained`` is terminal for THIS stream —
#: the job itself pauses, stays journaled, and resumes after restart).
_TERMINAL = ("job_done", "job_failed", "job_cancelled",
             "job_deadline_exceeded", "job_drained")


def submit_job(socket_path: str, job: dict, tenant: str = "default",
               timeout: Optional[float] = None,
               priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               idem_key: Optional[str] = None,
               auth_token: Optional[str] = None) -> List[dict]:
    """Submit ``job`` and stream its events to completion. Returns every
    event received ([..., terminal event] on success/failure, or
    [rejected] on admission refusal). Raises :class:`ServeConnectionLost`
    if the stream dies first (daemon killed mid-job — poll_result picks
    the job back up after the supervisor relaunch) and
    :class:`ServeTimeout` when a socket read outlives ``timeout``."""
    events: List[dict] = []
    job_id = None
    payload = {"op": "submit", "tenant": tenant, "job": job}
    if priority is not None:
        payload["priority"] = priority
    if deadline_s is not None:
        payload["deadline_s"] = deadline_s
    if idem_key is not None:
        payload["idem_key"] = idem_key
    if auth_token is not None:
        payload["auth_token"] = auth_token
    try:
        for ev in request(socket_path, payload, timeout=timeout):
            events.append(ev)
            kind = ev.get("event")
            if kind == "accepted":
                job_id = ev.get("job_id")
            if kind == "rejected" or kind in _TERMINAL:
                return events
    except socket.timeout:
        raise ServeTimeout(
            f"no event from the daemon within {timeout}s while waiting "
            f"on job {job_id or '<unacknowledged>'}",
            job_id=job_id) from None
    raise ServeConnectionLost(
        f"daemon stream closed before job "
        f"{job_id or '<unacknowledged>'} finished", job_id=job_id)


def update_job(socket_path: str, target_job_id: str, job: dict,
               idem_key: str, variant: Optional[str] = None,
               epochs: int = 0, tenant: str = "default",
               timeout: Optional[float] = None,
               priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               auth_token: Optional[str] = None) -> List[dict]:
    """Retrain ``target_job_id``'s published bundle from the new inputs in
    ``job`` and stream the events to the end: the ``update`` op.
    ``idem_key`` is required (a resubmit after a lost ack dedups instead
    of training twice); ``epochs`` bounds the warm-start fine-tune (0 lets
    the daemon pick). Returns and raises as :func:`submit_job` does."""
    events: List[dict] = []
    payload = {"op": "update", "job_id": target_job_id, "job": job,
               "idem_key": idem_key, "tenant": tenant}
    if variant is not None:
        payload["variant"] = variant
    if epochs:
        payload["epochs"] = int(epochs)
    if priority is not None:
        payload["priority"] = priority
    if deadline_s is not None:
        payload["deadline_s"] = deadline_s
    if auth_token is not None:
        payload["auth_token"] = auth_token
    try:
        for ev in request(socket_path, payload, timeout=timeout):
            events.append(ev)
            kind = ev.get("event")
            if kind == "rejected" or kind in _TERMINAL:
                return events
    except socket.timeout:
        raise ServeTimeout(
            f"no event from the daemon within {timeout}s while waiting "
            f"on the update of {target_job_id}") from None
    raise ServeConnectionLost(
        f"daemon stream closed before the update of {target_job_id} "
        f"finished")


def _one(socket_path: str, op: str, timeout: Optional[float],
         auth_token: Optional[str] = None, **fields) -> dict:
    payload = {"op": op, **fields}
    if auth_token is not None:
        payload["auth_token"] = auth_token
    for ev in request(socket_path, payload, timeout=timeout):
        return ev
    raise ServeConnectionLost(f"no response to {op!r}")


def status(socket_path: str, timeout: Optional[float] = 10.0) -> dict:
    return _one(socket_path, "status", timeout)


def ping(socket_path: str, timeout: Optional[float] = 5.0) -> dict:
    return _one(socket_path, "ping", timeout)


def shutdown(socket_path: str, timeout: Optional[float] = 10.0,
             auth_token: Optional[str] = None) -> dict:
    return _one(socket_path, "shutdown", timeout, auth_token=auth_token)


def cancel(socket_path: str, job_id: str,
           timeout: Optional[float] = 10.0,
           auth_token: Optional[str] = None) -> dict:
    """Cancel a queued (immediate) or running (cooperative, next
    shard/chunk boundary) job."""
    return _one(socket_path, "cancel", timeout, auth_token=auth_token,
                job_id=job_id)


def drain(socket_path: str, timeout: Optional[float] = 10.0,
          auth_token: Optional[str] = None) -> dict:
    """Ask the daemon to drain gracefully: admission closes, in-flight
    streaming jobs checkpoint, everything unfinished stays journaled."""
    return _one(socket_path, "drain", timeout, auth_token=auth_token)


def query(socket_path: str, q: str, job_id: Optional[str] = None,
          variant: Optional[str] = None, gene: Optional[str] = None,
          k: Optional[int] = None, timeout: Optional[float] = 30.0,
          auth_token: Optional[str] = None, mode: Optional[str] = None,
          nprobe: Optional[int] = None) -> dict:
    """One read-plane query (``neighbors`` / ``topk_biomarkers`` /
    ``meta`` / ``list``) against a daemon or the router — the router
    routes it to the bundle's home replica and answers from disk itself
    when that replica is dead. Token-gated like the mutators: query
    responses carry tenant embeddings/scores. ``mode`` picks the
    retrieval path (``approx`` default / ``exact`` ground truth);
    ``nprobe`` widens the approx probe."""
    fields = {"q": q}
    if job_id is not None:
        fields["job_id"] = job_id
    if variant is not None:
        fields["variant"] = variant
    if gene is not None:
        fields["gene"] = gene
    if k is not None:
        fields["k"] = k
    if mode is not None:
        fields["mode"] = mode
    if nprobe is not None:
        fields["nprobe"] = nprobe
    return _one(socket_path, "query", timeout, auth_token=auth_token,
                **fields)


def fquery(socket_path: str, fq: str, gene: str,
           k: Optional[int] = None, mode: Optional[str] = None,
           nprobe: Optional[int] = None, job_id: Optional[str] = None,
           variant: Optional[str] = None,
           ref_genes: Optional[List[str]] = None,
           timeout: Optional[float] = 30.0,
           auth_token: Optional[str] = None) -> dict:
    """One federated cross-bundle query (``gene_rank`` /
    ``bundle_overlap``). Against the router it scatter-gathers over the
    replica fleet (answering dead replicas' bundles from shared disk,
    with per-bundle ``served_by``/``replica_down`` attribution);
    against a single daemon it covers that daemon's bundles.
    ``bundle_overlap`` needs either ``ref_genes`` or a reference
    ``job_id``/``variant`` the server resolves into one."""
    fields: dict = {"fq": fq, "gene": gene}
    if k is not None:
        fields["k"] = k
    if mode is not None:
        fields["mode"] = mode
    if nprobe is not None:
        fields["nprobe"] = nprobe
    if job_id is not None:
        fields["job_id"] = job_id
    if variant is not None:
        fields["variant"] = variant
    if ref_genes is not None:
        fields["ref_genes"] = ref_genes
    return _one(socket_path, "fquery", timeout, auth_token=auth_token,
                **fields)


def result(socket_path: str, job_id: str,
           fields: Optional[List[str]] = None,
           max_bytes: Optional[int] = None,
           timeout: Optional[float] = 30.0,
           auth_token: Optional[str] = None) -> dict:
    """One ``result`` lookup with the response bounds: ``fields``
    selects top-level record keys, ``max_bytes`` caps the serialized
    response (an over-cap record comes back as a structured
    ``oversized_result`` error naming the available fields)."""
    extra = {}
    if fields is not None:
        extra["fields"] = fields
    if max_bytes is not None:
        extra["max_bytes"] = max_bytes
    return _one(socket_path, "result", timeout, auth_token=auth_token,
                job_id=job_id, **extra)


def submit_and_wait(socket_path: Addr, job: dict, tenant: str = "default",
                    state_dir: Optional[str] = None,
                    timeout: Optional[float] = None,
                    poll_deadline_s: float = 300.0,
                    priority: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    retries: int = 3, backoff: float = 0.25,
                    jitter: float = 0.25,
                    rng: Optional[random.Random] = None,
                    idem_key: Optional[str] = None,
                    auth_token: Optional[str] = None,
                    shed_retries: int = 3) -> dict:
    """Submit a job and return its terminal record, surviving daemon
    restarts AND replica failover behind a router.

    Every attempt carries the same idempotency key (auto-minted when the
    caller passes none), so a resubmission after a lost ack can never run
    the job twice — the server dedups on the key and answers with the
    original job_id. Transport-level failures retry with exponential
    backoff plus jitter (``backoff * 2**attempt + U[0, jitter)`` seconds —
    the jitter keeps a fleet of clients from re-dialing a relaunching
    daemon in lockstep). Recovery paths:

    - connect refused / reset BEFORE acceptance → resubmit with the same
      idem key (either nothing was journaled, or the dedup table
      re-acks the original);
    - stream lost AFTER acceptance (:class:`ServeConnectionLost` with a
      job_id) → the job is journaled somewhere; poll the durable record
      via :func:`poll_result` when a ``state_dir`` is known, else via
      :func:`poll_result_net` — which re-dials ``socket_path`` (the
      router, typically) on every attempt, so the answer arrives even
      after the job migrated replicas. Never resubmit here — the poll
      is strictly read-only.

    A ``rejected`` answer whose error is ``shed`` or ``tenant_quota``
    is the fleet's structured "try later": back off for the advised
    ``retry_after_s`` (plus jitter — an entire shed flash-crowd must not
    return in lockstep) and resubmit with the SAME idem key, up to
    ``shed_retries`` extra attempts; past that, raise
    :class:`ServeShed` naming the tenant and job_id. Shed retries spend
    their own budget, not the transport-retry one — a load-shedding
    fleet is healthy, a connection-refusing one is not.

    ``socket_path`` may be a LIST of router addresses (active router
    first, standbys after): each transport retry rotates to the next
    address under the same jittered backoff, so a standby takeover is
    one rotation away instead of a reconfiguration. The idem key makes
    the rotation safe — whichever router finally accepts dedups against
    everything its predecessors journaled.

    Raises :class:`ServeTimeout` naming the job when all retries or the
    result poll expire."""
    rng = rng if rng is not None else random.Random()
    addrs = _rotation(socket_path)
    if idem_key is None:
        idem_key = f"c-{uuid.uuid4().hex}"
    last: Optional[BaseException] = None
    sheds = 0
    attempt = 0
    while attempt <= retries:
        addr = addrs[attempt % len(addrs)]
        try:
            events = submit_job(addr, job, tenant=tenant,
                                timeout=timeout, priority=priority,
                                deadline_s=deadline_s, idem_key=idem_key,
                                auth_token=auth_token)
            ev = events[-1]
            if (ev.get("event") == "rejected"
                    and ev.get("error") in _SHED_ERRORS
                    and ev.get("retry_after_s") is not None):
                if sheds >= shed_retries:
                    raise ServeShed(
                        f"job {ev.get('job_id')} (tenant "
                        f"{ev.get('tenant', tenant)}) shed by admission "
                        f"({ev.get('error')}) on {sheds + 1} attempt(s); "
                        f"last advice: retry_after_s="
                        f"{ev.get('retry_after_s')}",
                        tenant=ev.get("tenant", tenant),
                        job_id=ev.get("job_id"),
                        retry_after_s=float(ev["retry_after_s"]))
                sheds += 1
                time.sleep(float(ev["retry_after_s"])
                           + rng.uniform(0.0, jitter))
                continue        # same idem key, no transport budget spent
            return ev
        except ServeConnectionLost as e:
            if e.job_id is not None:
                if state_dir is not None:
                    return poll_result(state_dir, e.job_id,
                                       deadline_s=poll_deadline_s)
                return poll_result_net(addrs, e.job_id,
                                       deadline_s=poll_deadline_s,
                                       rng=rng)
            last = e          # unacknowledged — the idem key makes the
            #                   resubmit below safe even if the ack was
            #                   written but never reached us
        except ServeTimeout:
            raise
        except (ConnectionError, FileNotFoundError, OSError) as e:
            last = e
        if attempt < retries:
            time.sleep(backoff * (2 ** attempt) + rng.uniform(0.0, jitter))
        attempt += 1
    raise ServeTimeout(
        f"submit failed after {retries + 1} attempt(s): "
        f"{type(last).__name__}: {last}") from last


def wait_ready(socket_path: str, deadline_s: float = 60.0,
               interval: float = 0.2) -> bool:
    """Poll until the daemon answers ``ping`` (socket may not exist yet
    during startup). True when ready, False at the deadline."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            if ping(socket_path).get("event") == "pong":
                return True
        except (OSError, ServeConnectionLost, protocol.ProtocolError):
            pass
        time.sleep(interval)
    return False


def poll_result(state_dir: str, job_id: str, deadline_s: float = 300.0,
                interval: float = 0.25) -> dict:
    """Wait for ``<state_dir>/results/<job_id>.json`` — the durable
    terminal record, written even when no client is connected (and the
    recovery path after :class:`ServeConnectionLost`)."""
    path = os.path.join(state_dir, "results", f"{job_id}.json")
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass        # mid-write; atomic rename makes this brief
        time.sleep(interval)
    raise ServeTimeout(f"no result record for job {job_id} within "
                       f"{deadline_s:.0f}s ({path})", job_id=job_id)


def poll_result_net(socket_path: Addr, job_id: str,
                    deadline_s: float = 300.0, interval: float = 0.5,
                    jitter: float = 0.5,
                    rng: Optional[random.Random] = None) -> dict:
    """Wait for a job's durable terminal record via the ``result`` op —
    the network twin of :func:`poll_result` for clients that cannot see
    the server's filesystem (TCP mode, or any fleet behind the router).

    Re-dials ``socket_path`` on EVERY attempt: when that address is the
    router's, each poll re-resolves to whichever replica currently holds
    the record, so the answer arrives even while the job is migrating
    between replicas mid-failover. Strictly read-only — it can never
    duplicate work, only observe it. Transport errors (the router itself
    restarting, a replica relaunching) back off with jitter so a fleet
    of waiting clients doesn't re-dial in lockstep; ``pending`` answers
    poll at the flat ``interval``. A LIST of addresses (router +
    standbys) rotates to the next entry on each transport failure —
    strictly read-only, so asking every router is always safe.

    Raises :class:`ServeTimeout` naming ``job_id`` at the deadline."""
    rng = rng if rng is not None else random.Random()
    addrs = _rotation(socket_path)
    deadline = time.time() + deadline_s
    fails = 0
    idx = 0
    while time.time() < deadline:
        try:
            for ev in request(addrs[idx % len(addrs)],
                              {"op": "result", "job_id": job_id},
                              timeout=min(30.0, deadline_s)):
                if ev.get("event") not in ("pending", "error"):
                    return ev
                break
            fails = 0
            time.sleep(interval)
        except (OSError, ServeConnectionLost, protocol.ProtocolError):
            fails += 1
            idx += 1            # rotate: maybe a standby answers
            time.sleep(min(8.0, interval * (2 ** min(fails, 4)))
                       + rng.uniform(0.0, jitter))
    raise ServeTimeout(f"no result record for job {job_id} within "
                       f"{deadline_s:.0f}s (via {addrs})",
                       job_id=job_id)


# ---- degraded mode (no router answers) ----------------------------------
#
# The fleet's replicas publish their own ``tcp_addr`` files on the shared
# fleet disk; a client that can read that disk can keep working when
# every router is partitioned away or dead. Reads (status / result /
# query) fan out to the replicas directly — they can never duplicate
# work. Submits are allowed ONLY with an idempotency key: the key
# derives the job_id, the chosen replica's dedup table absorbs retries,
# and the first healed router's sticky scan finds the journal entry or
# result record wherever it landed — reconciliation IS the idem key.


def fleet_addrs(fleet_dir: str) -> List[str]:
    """Replica addresses published under ``<fleet_dir>/<name>/state/
    tcp_addr``, sorted by replica name. Replicas that never bound (no
    file) or are mid-relaunch (empty file) are skipped."""
    out: List[str] = []
    for path in sorted(glob.glob(os.path.join(
            fleet_dir, "*", "state", "tcp_addr"))):
        try:
            with open(path) as fh:
                addr = fh.read().strip()
        except OSError:
            continue
        if addr:
            out.append(addr)
    return out


def router_addrs(fleet_dir: str) -> List[str]:
    """The active router's published address (``<fleet_dir>/
    router_addr``), as a rotation list — [] when no router ever bound."""
    try:
        with open(os.path.join(fleet_dir, "router_addr")) as fh:
            addr = fh.read().strip()
    except OSError:
        return []
    return [addr] if addr else []


def degraded_result(fleet_dir: str, job_id: str,
                    timeout: Optional[float] = 10.0,
                    auth_token: Optional[str] = None) -> dict:
    """``result`` fan-out across the replicas: the first durable record
    wins; otherwise ``pending`` (some replica reachable, none finished)
    or a structured ``no_replicas`` error."""
    reached = False
    for addr in fleet_addrs(fleet_dir):
        try:
            ev = result(addr, job_id, timeout=timeout,
                        auth_token=auth_token)
        except (OSError, ServeConnectionLost, protocol.ProtocolError):
            continue
        reached = True
        if ev.get("event") not in ("pending", "error"):
            return dict(ev, degraded=True)
    if reached:
        return {"event": "pending", "job_id": job_id, "degraded": True}
    return {"event": "error", "error": "no_replicas", "degraded": True,
            "detail": f"no replica reachable via {fleet_dir}"}


def degraded_query(fleet_dir: str, q: str, job_id: Optional[str] = None,
                   variant: Optional[str] = None,
                   gene: Optional[str] = None, k: Optional[int] = None,
                   timeout: Optional[float] = 10.0,
                   auth_token: Optional[str] = None) -> dict:
    """Read-plane query fan-out: first replica that answers without an
    error serves it (only the bundle's home replica has the inventory,
    the rest answer ``not_found``)."""
    last: Optional[dict] = None
    for addr in fleet_addrs(fleet_dir):
        try:
            ev = query(addr, q, job_id=job_id, variant=variant,
                       gene=gene, k=k, timeout=timeout,
                       auth_token=auth_token)
        except (OSError, ServeConnectionLost, protocol.ProtocolError):
            continue
        if not ev.get("error"):
            return dict(ev, degraded=True)
        last = ev
    if last is not None:
        return dict(last, degraded=True)
    return {"event": "error", "error": "no_replicas", "degraded": True,
            "detail": f"no replica reachable via {fleet_dir}"}


def degraded_status(fleet_dir: str,
                    timeout: Optional[float] = 5.0) -> dict:
    """Per-replica status roll-up assembled client-side — the degraded
    twin of the router's ``status`` aggregate."""
    reps = {}
    for addr in fleet_addrs(fleet_dir):
        try:
            reps[addr] = status(addr, timeout=timeout)
        except (OSError, ServeConnectionLost, protocol.ProtocolError):
            reps[addr] = {"event": "error", "error": "unreachable"}
    return {"event": "status", "role": "degraded_client",
            "degraded": True, "fleet_dir": fleet_dir, "replicas": reps}


def degraded_submit(fleet_dir: str, job: dict, tenant: str = "default",
                    idem_key: Optional[str] = None,
                    timeout: Optional[float] = None,
                    priority: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    auth_token: Optional[str] = None) -> List[dict]:
    """Keyed submit straight to a replica while no router answers.

    Requires an ``idem_key`` (minted when absent — the caller should
    keep it for retries): the key derives the job_id, so this submit is
    reconcilable no matter where it lands. Before submitting, every
    reachable replica is asked for the durable record — a job that
    already ran anywhere dedups client-side. The target replica is
    chosen deterministically from the key over the reachable set, so a
    degraded retry of the same key lands on the same replica and its
    dedup table absorbs it. Raises :class:`ServeConnectionLost` when no
    replica is reachable at all."""
    if idem_key is None:
        idem_key = f"d-{uuid.uuid4().hex}"
    jid = protocol.idem_job_id(idem_key)
    rec = degraded_result(fleet_dir, jid, auth_token=auth_token)
    if rec.get("event") not in ("pending", "error"):
        return [{"event": "accepted", "job_id": jid, "deduped": True,
                 "degraded": True}, rec]
    addrs = fleet_addrs(fleet_dir)
    if not addrs:
        raise ServeConnectionLost(
            f"degraded submit: no replica published an address under "
            f"{fleet_dir}", job_id=jid)
    # Deterministic placement over the *reachable* set: stable for
    # retries of the same key, no coordination required.
    target = addrs[zlib.crc32(idem_key.encode()) % len(addrs)]
    events = submit_job(target, job, tenant=tenant, timeout=timeout,
                        priority=priority, deadline_s=deadline_s,
                        idem_key=idem_key, auth_token=auth_token)
    return [dict(ev, degraded=True) for ev in events]
