"""Wire protocol for ``g2vec serve``: JSONL over a UNIX or TCP socket.

The port's copy of ``g2vec_tpu/serve/protocol.py``, with the same wire
format: a client of either package talks to a daemon of the other.

One request object per connection, newline-terminated; the daemon answers
with a stream of newline-delimited JSON events and closes the stream after
the terminal event (``accepted``/``rejected`` + per-job progress ending in
``job_done``/``job_failed``/``job_cancelled``/``job_deadline_exceeded``/
``job_drained`` for submits; a single event for
``status``/``ping``/``shutdown``/``cancel``/``drain``). Line-delimited
JSON keeps both sides trivially incremental — the daemon can stream a
job's events as they happen and a shell client is one ``nc -U`` away.

The same socket also answers plain HTTP ``GET /status`` (detected from the
request's first bytes), so ``curl --unix-socket <sock> http://g2vec/status``
works without a client library.

Requests::

    {"op": "submit", "tenant": "alice", "job": {...},    # see daemon.py
     "priority": "interactive", "deadline_s": 120}       # both optional
    {"op": "status"} | {"op": "ping"} | {"op": "shutdown"}
    {"op": "cancel", "job_id": "j0001-..."}              # cooperative
    {"op": "result", "job_id": "i...",   # durable record or "pending";
     "fields": ["event", "variants"],    # optional top-level selector
     "max_bytes": 65536}                 # optional response size cap
    {"op": "query", "q": "neighbors", "job_id": "i...",  # read plane:
     "variant": "base", "gene": "TP53", "k": 10}         # see QUERY_KEYS
    {"op": "update", "job_id": "i...", "job": {...},     # incremental
     "epochs": 10}      # delta re-walk + warm-start, see UPDATE_KEYS
    {"op": "drain"}     # stop admitting, checkpoint, journal, exit 0

Addressing: an address containing ``host:port`` dials TCP, anything else
is a UNIX socket path — :func:`parse_addr` / :func:`dial` keep client,
router, and tooling on one resolver. TCP adds two request fields:
``auth_token`` (checked at admission for mutating ops when the listener
was started with a token) and ``idem_key`` (client-generated idempotency
key; resubmits with the same key are acked once, see daemon.py).
"""
from __future__ import annotations

import hashlib
import json
import re
import socket
from typing import IO, Optional, Tuple, Union

#: Client-generated idempotency keys (``idem_key`` in a submit payload).
#: Lives here — not in daemon.py — because the jax-free router must
#: derive job ids too (sticky routing: a key the fleet has seen resolves
#: to its existing home replica, never to a fresh ring placement).
MAX_IDEM_KEY = 128


def idem_job_id(idem_key: str) -> str:
    """Derive the job_id from the idempotency key. Same key -> same id
    -> same journal/checkpoint/result names on ANY replica: the naming
    scheme IS the exactly-once mechanism."""
    return "i" + hashlib.sha256(idem_key.encode()).hexdigest()[:12]

#: One line must fit a submit with a large manifest, with headroom; a
#: longer line is a protocol error, not an OOM.
MAX_LINE_BYTES = 8 << 20

#: The submit-payload envelope vocabulary. Every key daemon.py or
#: router.py reads off a submit payload must be declared here — the
#: config/doc-drift checker (analyze/configdoc.py) enforces it, so a
#: typo'd ``payload.get("pirority")`` fails tier-1 instead of silently
#: returning the default. Job-CONTENT keys (the ``job`` object's
#: fields) are governed separately by config.SERVE_JOB_KEYS.
#: ``requeue``/``submitted_at`` are router-internal (set only by the
#: failover journal migration): requeue skips the tenant-quota and
#: shed gates — the job already paid admission once and the client
#: holds an ack — and submitted_at carries the ORIGINAL admission
#: time so a replica death never resets a deadline clock. Because
#: every client shares the fleet ``auth_token``, that token cannot
#: prove router-ness: both fields are honored only when the payload
#: carries the target replica's ``relay_token`` (a per-state-dir
#: secret readable only via the replica's filesystem — the router
#: co-hosts the state dirs, network tenants do not), and the router
#: strips all three from externally received submits before relaying.
#: ``router_epoch`` is the leadership fencing epoch (serve/leader.py):
#: a router holding the lease stamps every mutating command with its
#: epoch, daemons persist the highest epoch they have witnessed, and a
#: mutating command carrying a LOWER epoch gets a structured
#: ``stale_epoch`` reject — a zombie ex-leader that lost the lease
#: mid-partition can no longer fence replicas or migrate journals.
#: Absent/0 means "no leadership machinery" (single-router fleets and
#: degraded-mode clients) and is always accepted.
SUBMIT_KEYS = ("op", "job", "tenant", "priority", "deadline_s",
               "idem_key", "job_id", "auth_token", "requeue",
               "submitted_at", "relay_token", "router_epoch")

#: The query-request envelope vocabulary (the read plane's twin of
#: SUBMIT_KEYS). daemon.py/router.py bind a query payload to the
#: conventional name ``qreq`` and the same checker lints every
#: ``qreq["k"]`` / ``qreq.get("k")`` site against this tuple. ``q``
#: names the sub-op (inventory.QUERY_SUBOPS: neighbors /
#: topk_biomarkers / meta / list); ``variant`` selects a lane of a
#: multi-variant job (optional when the job has exactly one).
#: ``mode`` picks the retrieval path (``approx`` — the IVF index with
#: exact rescoring, the default — or ``exact``, the ground-truth
#: blocked kernel) and ``nprobe`` widens the approx probe; both ride
#: the cache key so approx and exact results never collide.
QUERY_KEYS = ("op", "q", "job_id", "variant", "gene", "k", "mode",
              "nprobe", "auth_token")

#: The federated-query envelope vocabulary: ``fqreq`` reads in
#: daemon.py/router.py are linted against this tuple. ``fq`` names the
#: cross-bundle sub-op (inventory.FQUERY_SUBOPS: ``gene_rank`` — which
#: bundles rank ``gene`` in their top-k prognostic scores — or
#: ``bundle_overlap`` — bundles ranked by neighbor-set overlap with a
#: reference bundle's neighborhood of ``gene``). ``job_id``/``variant``
#: name the reference bundle for ``bundle_overlap``; ``ref_genes`` is
#: the router-resolved reference neighbor list it forwards to replicas
#: so every partial is scored against the same reference.
FQUERY_KEYS = ("op", "fq", "gene", "k", "mode", "nprobe", "job_id",
               "variant", "ref_genes", "auth_token")

#: The update-request envelope vocabulary: ``ureq`` reads in
#: daemon.py/router.py are linted against this tuple. ``update`` is the
#: write half of the read plane: ``job_id``/``variant`` name the target
#: bundle (the prior generation), ``job`` carries the UPDATED input
#: config (same vocabulary as a submit's ``job``, validated by
#: config.SERVE_JOB_KEYS), ``epochs`` bounds the warm-start fine-tune
#: (0 = the engine's default cap). Updates are idempotency-keyed and
#: journaled exactly like submits — ``idem_key`` resubmits ack the same
#: derived id; a SIGKILL mid-update replays from the journal — and the
#: router sticky-routes them to the target bundle's home replica so the
#: generation pointer has exactly one writer. ``requeue``/
#: ``submitted_at``/``relay_token``/``router_epoch`` carry the same
#: failover/fencing semantics as SUBMIT_KEYS.
UPDATE_KEYS = ("op", "job_id", "variant", "job", "tenant", "epochs",
               "priority", "deadline_s", "idem_key", "auth_token",
               "requeue", "submitted_at", "relay_token", "router_epoch")

#: The result-request envelope vocabulary: ``rreq`` reads in
#: daemon.py/router.py are linted against this tuple. ``fields``
#: selects top-level record keys; ``max_bytes`` caps the serialized
#: response (the server-side ``--max-result-bytes`` bound applies
#: regardless — a giant durable record must not blow the line protocol
#: in reverse).
RESULT_KEYS = ("op", "job_id", "fields", "max_bytes", "auth_token")


class ProtocolError(ValueError):
    """A malformed request/response line."""


def bound_record(rec: dict, fields, max_bytes: Optional[int],
                 server_cap: int) -> dict:
    """Apply the ``result`` op's field selector and size bound.

    ``fields`` (optional list) keeps only those top-level record keys
    (plus ``event``/``job_id`` so the response stays self-describing);
    the effective cap is the smaller of the client's ``max_bytes`` and
    the server's ``--max-result-bytes``. An over-cap record becomes a
    structured ``oversized_result`` error naming the available fields
    so the client can re-ask for a subset — it is never truncated
    mid-JSON. Shared by daemon and router so both listeners bound
    identically.
    """
    cap = int(server_cap)
    if max_bytes:
        cap = min(cap, int(max_bytes))
    if fields is not None:
        if not (isinstance(fields, list)
                and all(isinstance(k, str) for k in fields)):
            return {"event": "error", "error": "bad_fields",
                    "detail": "fields must be a list of strings"}
        keep = set(fields) | {"event", "job_id"}
        rec = {k: v for k, v in rec.items() if k in keep}
    size = len(json.dumps(rec).encode())
    if size > cap:
        return {"event": "error", "error": "oversized_result",
                "job_id": rec.get("job_id"), "bytes": size,
                "max_bytes": cap,
                "fields_available": sorted(rec.keys())}
    return rec


#: ``host:port`` — hostname/IPv4 literal, no scheme. A bare path never
#: matches (paths contain ``/`` or no colon), so UNIX sockets stay the
#: default and nothing existing re-resolves.
_TCP_ADDR = re.compile(r"^([A-Za-z0-9._-]+):([0-9]{1,5})$")


def parse_addr(addr: str) -> Union[Tuple[str, int], str]:
    """``"host:port"`` → ``(host, port)`` for TCP; anything else is
    returned unchanged as a UNIX socket path."""
    m = _TCP_ADDR.match(addr)
    if m:
        port = int(m.group(2))
        if port > 65535:
            raise ProtocolError(f"port out of range in {addr!r}")
        return m.group(1), port
    return addr


def dial(addr: str, timeout: Optional[float] = None) -> socket.socket:
    """Connect to a serve endpoint — TCP for ``host:port``, UNIX
    otherwise. The returned socket has ``timeout`` applied (None = block
    forever), matching both listeners' JSONL framing."""
    parsed = parse_addr(addr)
    if isinstance(parsed, tuple):
        sock = socket.create_connection(parsed, timeout=timeout)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(parsed)
    sock.settimeout(timeout)
    return sock


def write_event(f: IO[bytes], obj: dict) -> None:
    """One JSONL record, flushed — event streams must not sit in buffers."""
    f.write(json.dumps(obj).encode() + b"\n")
    f.flush()


def read_event(f: IO[bytes]) -> Optional[dict]:
    """The next JSONL record, or None on a closed stream."""
    line = f.readline(MAX_LINE_BYTES)
    if not line:
        return None
    if len(line) >= MAX_LINE_BYTES and not line.endswith(b"\n"):
        raise ProtocolError(
            f"line exceeds {MAX_LINE_BYTES} bytes — truncated or not a "
            f"g2vec serve peer")
    try:
        obj = json.loads(line)
    except ValueError as e:
        raise ProtocolError(f"not a JSON line: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"expected a JSON object per line, got {type(obj).__name__}")
    return obj
