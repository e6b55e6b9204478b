"""The resident job daemon: one warm card owner, many jobs.

The port's copy of ``g2vec_tpu/serve/daemon.py``, the single daemon.
Every solo run pays process start-up, the card's first use and its reads
before its first useful launch; this daemon keeps one process resident:

- **One ResidentEngine** (batch/engine.py) owns the card for the daemon's
  lifetime: the walk tier's memo and the preprocessed-dataset memo stay
  warm across jobs, and the kernels are built once.
- **Admission control**: a bounded multi-tenant queue. A full queue
  rejects with a structured ``queue_full`` error; malformed jobs reject
  at submit time with the offending key named (the JAX package's
  messages, config.py's job schema); per-tenant token buckets
  (``--tenant-quotas``) and deadline-aware shedding (``--shed``); an
  idempotency table (``idem_key``) acks a resubmission once.
- **Joined batches**: when a job is popped, every queued job whose
  non-variant config coincides (``config.serve_join_key``) joins the
  same engine batch, so K compatible jobs cost one walk product set and
  one lane launch of each packed kernel a step instead of K solo runs.
- **Tenant fairness**: the queue pops weighted round-robin across
  tenants, interactive before batch, with aging so batch never starves.
- **Per-job JSONL result streaming**: a submitting client holds its
  connection and receives the job's events (accepted/started/lane_done/
  job_done) as they happen; the terminal record is also written to
  ``<state-dir>/results/<job_id>.json``.
- **Crash recovery**: accepted jobs are journaled to
  ``<state-dir>/jobs/<job_id>.json`` and un-journaled on completion. A
  relaunch (``serve --supervise``, resilience/supervisor.py
  ``supervise_serve``) re-queues every journaled job; ``--cache-dir``
  keeps the walks. Streaming jobs resume from their (epoch, shard)
  cursor under ``<state-dir>/ckpt/``.
- **Job lifecycle**: per-job ``priority``, ``deadline_s`` (measured from
  the original submission, surviving restarts), client ``cancel``
  (cooperative: the trainers' check hook raises at the next epoch or
  shard boundary), and graceful drain (SIGTERM or the ``drain`` op:
  admission closes, in-flight streaming jobs cut a cursor, everything
  unfinished stays journaled, the process exits 0).
- **The query plane**: each finished lane publishes a memory-mapped
  bundle under ``<state-dir>/inventory/<job_id>/<variant>/``
  (``io/writers.write_inventory_bundle``) that the ``query``/``fquery``
  ops read (serve/inventory.py), host numpy as in the JAX package.
- **Leadership fencing**, daemon side: the fence marker and the router
  epoch file (serve/leader.py) are read on every admission and step.

The daemon runs on the card unless ``--device cpu``: with no card it
raises at start (``device.resolve_device``). A kernel that fails to
build or launch fails its batch through
``resilience.supervisor.classify_exception`` (fatal for a broken CUDA
context), never by a move to the plain version.

- **The update op**: an ``update`` payload rides the submit pipeline
  (validation, idempotency key required, quotas, journal, recovery) but
  plans into a lane-less job that runs the incremental engine
  (``incremental.run_update``: delta re-walk and warm-start fine-tune on
  the daemon's device) against the target bundle's live generation, then
  publishes the next generation atomically with its
  ``delta_fingerprints.json``.

Outputs are BYTE-IDENTICAL to the same config run solo (same device and
dtype): jobs execute through the engine's lanes, each of which writes
its solo run's bytes; the daemon only renames the spool files to each
job's requested ``result_name``.
"""
from __future__ import annotations

import dataclasses
import glob
import hmac
import os
import queue
import re
import secrets
import shutil
import socket
import sys
import threading
import time
import uuid
from collections import Counter, OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from g2vec_tpu_torch.batch.engine import (LaneVariant, ManifestError,
                                          ResidentEngine, _variant_from_dict,
                                          seed_sweep_variants)
from g2vec_tpu_torch.config import (G2VecConfig, config_from_job,
                                    serve_join_key)
from g2vec_tpu_torch.resilience.lifecycle import (DrainRequested,
                                                  JobCancelled,
                                                  JobDeadlineExceeded,
                                                  JobInterrupted,
                                                  TokenBucket, shed_decision)
from g2vec_tpu_torch.serve import inventory, leader, protocol
from g2vec_tpu_torch.utils.integrity import write_json_atomic
from g2vec_tpu_torch.utils.metrics import MetricsWriter

_TENANT_MAX = 64
#: Job priority classes: ``interactive`` pops before ``batch``; aging
#: (ServeOptions.aging_s) promotes a long-waiting batch job so a steady
#: interactive stream can never starve it.
PRIORITIES = ("interactive", "batch")
#: Lanes one job may submit; a bigger sweep should be several jobs (the
#: scheduler joins them anyway) so admission stays per-tenant fair.
MAX_JOB_LANES = 64

#: The job-join key (config.serve_join_key): jobs whose keys are equal
#: join one engine batch.
_join_key = serve_join_key

#: Client-generated idempotency keys (``idem_key`` in a submit payload).
#: The daemon derives the job_id from the key, so the SAME submission —
#: retried through a router after a replica death, or re-queued onto a
#: survivor — maps onto one job everywhere: one journal entry, one
#: streaming-cursor directory, one terminal record. Defined in
#: protocol.py, where the router shares the derivation.
MAX_IDEM_KEY = protocol.MAX_IDEM_KEY
idem_job_id = protocol.idem_job_id

#: Explicit ``job_id`` on a submit payload (router failover resubmits of
#: keyless jobs — see router._failover). job_ids name files under the
#: state dir, so the charset is locked down: no separators, no dotfiles.
_JOB_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,79}")


def _update_fields(ureq: dict, idem_key: Optional[str], variants_spec,
                   seeds) -> Tuple[str, Optional[str], int]:
    """An ``update`` envelope's target, variant and epoch bound, with the
    JAX daemon's checks and messages. ``ureq`` is the envelope's
    conventional name: the config-doc-drift checker holds its keys to
    ``protocol.UPDATE_KEYS``."""
    if not idem_key:
        raise ValueError(
            "update requires 'idem_key' — the op is "
            "idempotency-keyed by contract (resubmits after a "
            "lost ack must dedup, and failover re-derives the "
            "same id on any replica)")
    target = ureq.get("job_id")
    if not isinstance(target, str) or not target:
        raise ValueError("update needs a 'job_id' string naming "
                         "the target bundle")
    uvariant = ureq.get("variant")
    if uvariant is not None and not isinstance(uvariant, str):
        raise ValueError(f"'variant' must be a string, got {uvariant!r}")
    epochs = ureq.get("epochs", 0)
    if not isinstance(epochs, int) or isinstance(epochs, bool) \
            or epochs < 0:
        raise ValueError(f"'epochs' must be a non-negative int, "
                         f"got {epochs!r}")
    if variants_spec is not None or seeds:
        raise ValueError("an update job cannot set 'variants' "
                         "or 'seeds' — it targets one existing "
                         "bundle")
    return target, uvariant, epochs


class QueueFull(RuntimeError):
    """Admission rejected: the bounded job queue is at capacity."""


@dataclasses.dataclass
class ServeOptions:
    """Daemon configuration (the ``g2vec serve`` flag surface)."""

    socket_path: str
    state_dir: str
    #: The card the engine runs on (``cuda`` unless the caller asks for
    #: ``cpu``); with no card visible the daemon raises at start.
    device: str = "cuda"
    queue_depth: int = 16        # max jobs queued (not yet executing)
    max_join: int = 4            # max jobs merged into one engine batch
    job_retries: int = 1         # in-process retries for retryable failures
    aging_s: float = 30.0        # batch job older than this outranks interactive
    cache_dir: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    fault_plan: Optional[str] = None
    #: TCP front door ("host:port", port 0 = ephemeral): a second listener
    #: speaking the same JSONL protocol + HTTP /status. The UNIX socket
    #: stays — local clients and the router keep their cheap path.
    listen: Optional[str] = None
    #: Shared-secret tenancy for the network listener: when set, every
    #: MUTATING op (submit/cancel/drain/shutdown) must carry a matching
    #: ``auth_token`` field or is rejected at admission. ``status``/
    #: ``ping`` stay open — health probes must not need secrets.
    auth_token: Optional[str] = None
    #: Per-connection socket deadline: a client that stalls mid-request
    #: (or stops reading its event stream) is disconnected instead of
    #: holding a handler thread forever.
    read_deadline_s: float = 30.0
    #: Hard bound on one request line; an oversized request is answered
    #: with a structured error, never buffered past this.
    max_request_bytes: int = 0   # 0 = protocol.MAX_LINE_BYTES
    #: Query plane: byte budget for the memory-mapped bundle
    #: LRU — resident cost is mapped PAGES the kernels touch, so this
    #: bounds address-space bookkeeping, not copies.
    inventory_budget_bytes: int = 256 << 20
    #: Entries in the keyed query-result LRU (results are tiny —
    #: k genes + k floats — so a count bound suffices).
    query_cache_entries: int = 128
    #: Extra catalog root beyond ``<state>/inventory`` — point the
    #: daemon at a directory of solo ``--emit-inventory`` bundles to
    #: make them queryable without a serve job.
    inventory_dir: Optional[str] = None
    #: IVF list count for published bundles (ops/ann.resolve_nlist):
    #: 0 auto-indexes bundles past the size threshold, <0 disables the
    #: approximate plane entirely, >0 forces a list count (tests use
    #: this to index tiny bundles).
    ann_nlist: int = 0
    #: Server-side cap on one ``result`` response; an over-cap record
    #: becomes a structured ``oversized_result`` error (see
    #: protocol.bound_record). 0 = protocol.MAX_LINE_BYTES.
    max_result_bytes: int = 0
    #: Per-tenant admission SLOs: ``name:rate:burst[:weight];...`` —
    #: ``rate`` submissions/second refilling a ``burst``-deep token
    #: bucket, plus a weighted-fair queue share (see
    #: :func:`parse_tenant_quotas`). ``*`` names the default applied to
    #: unlisted tenants; with no ``*`` entry, unlisted tenants are
    #: unlimited (weight 1). None disables rate limiting entirely.
    tenant_quotas: Optional[str] = None
    #: Deadline-aware load shedding: reject a deadlined job at admission
    #: (structured ``shed`` + ``retry_after_s``) when the estimated
    #: queue wait already exceeds its whole ``deadline_s`` — refusing
    #: up-front beats accepting work that dies of deadline_exceeded
    #: after burning a lane (lifecycle.shed_decision has the boundary
    #: semantics).
    shed: bool = False


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission SLO: token-bucket rate limit + fair share."""

    rate: float                  # submissions/second refill
    burst: float                 # bucket capacity (max burst size)
    weight: int = 1              # weighted-fair queue share


def parse_tenant_quotas(spec: Optional[str]) -> Dict[str, TenantQuota]:
    """Parse a ``--tenant-quotas`` spec: semicolon-separated
    ``name:rate:burst[:weight]`` entries, e.g.
    ``gold:4:8:3;bulk:0.5:2:1;*:2:4:1``. ``*`` is the default for
    tenants not named. Raises ValueError naming the bad entry."""
    quotas: Dict[str, TenantQuota] = {}
    if not spec:
        return quotas
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad --tenant-quotas entry {entry!r}: expected "
                f"name:rate:burst[:weight]")
        name = parts[0].strip()
        if not name or len(name) > _TENANT_MAX:
            raise ValueError(f"bad --tenant-quotas tenant name {name!r}")
        if name in quotas:
            raise ValueError(f"duplicate --tenant-quotas tenant {name!r}")
        try:
            rate, burst = float(parts[1]), float(parts[2])
            weight = int(parts[3]) if len(parts) == 4 else 1
        except ValueError:
            raise ValueError(
                f"bad --tenant-quotas entry {entry!r}: rate/burst must "
                f"be numbers, weight an int") from None
        if rate <= 0 or burst < 1:
            raise ValueError(
                f"bad --tenant-quotas entry {entry!r}: need rate > 0 "
                f"and burst >= 1")
        if weight < 1:
            raise ValueError(
                f"bad --tenant-quotas entry {entry!r}: weight must "
                f"be >= 1")
        quotas[name] = TenantQuota(rate=rate, burst=burst, weight=weight)
    return quotas


@dataclasses.dataclass
class ServeJob:
    """One admitted job: a validated config + planned lanes + routing."""

    job_id: str
    tenant: str
    cfg: G2VecConfig
    variants: List[LaneVariant]
    raw: dict                    # the submit payload, journal currency
    submitted_at: float
    join_key: Tuple = ()
    attempts: int = 0
    subscriber: Optional["queue.Queue"] = None
    priority: str = "batch"
    #: Wall-clock budget measured from ``submitted_at`` (the ORIGINAL
    #: submission, surviving journal recovery — a deadline is a promise
    #: to the client, not to whichever daemon incarnation runs the job).
    deadline_s: Optional[float] = None
    queued_at: float = 0.0       # set at each (re)queue; drives aging
    #: Client-generated idempotency key; job_id is derived from it, so a
    #: retried/re-routed submission dedups instead of duplicating.
    idem_key: Optional[str] = None
    #: Set (to the target bundle's job_id) when this job is an ``update``:
    #: it carries no lanes, runs the incremental engine instead of an
    #: engine batch and publishes the target's next generation. Its
    #: join_key is unique, so it never joins a training batch.
    update_of: Optional[str] = None
    update_variant: Optional[str] = None
    update_epochs: int = 0       # 0: incremental.run_update's default
    cancel_ev: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def deadline_expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        return (time.time() if now is None else now) \
            > self.submitted_at + self.deadline_s


class _FairQueue:
    """Bounded multi-tenant, two-priority FIFO with round-robin pop.

    Per-tenant deques inside two priority tiers. ``pop`` order is
    strict-priority with aging: an aged batch job (queued longer than
    ``aging_s``) first, then any interactive job, then any batch job —
    so interactive jobs cut the line but can never starve batch work.
    Within a tier tenants are served weighted round-robin: a tenant
    with ``weight`` w (from ``--tenant-quotas``, default 1) gets up to w
    consecutive pops before rotating to the back — over a full rotation
    the tenants' service counts converge to their weight ratio. With no
    weights configured this degenerates to exactly the old one-pop
    round-robin, so a tenant submitting N jobs waits behind every other
    tenant once per own job, not zero times.
    ``take_compatible`` pulls additional queued jobs with a matching join
    key (any tenant or priority, FIFO within each) for batch joining —
    those jobs would only have waited longer by staying queued.
    """

    def __init__(self, depth: int, aging_s: float = 30.0,
                 weights: Optional[Dict[str, int]] = None):
        self._depth = depth
        self._aging_s = aging_s
        #: tenant -> fair-share weight; ``*`` is the default for
        #: unlisted tenants. Immutable after construction.
        self._weights: Dict[str, int] = dict(weights or {})
        # guarded-by: _lock
        self._tiers: Dict[str, "OrderedDict[str, deque]"] = {
            p: OrderedDict() for p in PRIORITIES}
        #: Per-tier deficit counters for the weighted round-robin:
        #: remaining consecutive pops before this tenant rotates.
        # guarded-by: _lock
        self._credits: Dict[str, Dict[str, int]] = {
            p: {} for p in PRIORITIES}
        self._n = 0                  # guarded-by: _lock
        self._lock = threading.Lock()
        # Holding _not_empty IS holding _lock (Condition wraps it) —
        # the checker understands the aliasing.
        self._not_empty = threading.Condition(self._lock)

    def _weight(self, tenant: str) -> int:
        return max(1, self._weights.get(tenant,
                                        self._weights.get("*", 1)))

    def depth(self) -> int:
        with self._lock:
            return self._n

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {p: sum(len(dq) for dq in tier.values())
                    for p, tier in self._tiers.items()}

    def push(self, job: ServeJob) -> None:
        with self._lock:
            if self._n >= self._depth:
                raise QueueFull(
                    f"job queue is full ({self._n}/{self._depth})")
            job.queued_at = time.time()
            tier = self._tiers[job.priority]
            tier.setdefault(job.tenant, deque()).append(job)
            self._n += 1
            self._not_empty.notify()

    # analyze: holds[_lock] — pop()'s wait loop already owns the
    # Condition; the checker verifies every call site holds the lock.
    def _pop_tier(self, pname: str,
                  min_age: float = 0.0) -> Optional[ServeJob]:
        tier = self._tiers[pname]
        credits = self._credits[pname]
        now = time.time()
        for name, dq in list(tier.items()):
            if dq and (not min_age or now - dq[0].queued_at >= min_age):
                cr = credits.get(name, self._weight(name)) - 1
                if cr <= 0:
                    # Share spent: reset and rotate to the back.
                    credits[name] = self._weight(name)
                    tier.move_to_end(name)
                else:
                    credits[name] = cr      # keep serving this tenant
                self._n -= 1
                return dq.popleft()
        return None

    def pop(self, timeout: Optional[float] = None) -> Optional[ServeJob]:
        with self._not_empty:
            if not self._n:
                self._not_empty.wait(timeout)
            job = self._pop_tier("batch",
                                 min_age=self._aging_s)     # aged first
            if job is None:
                job = self._pop_tier("interactive")
            if job is None:
                job = self._pop_tier("batch")
            return job

    def take_compatible(self, key: Tuple, limit: int) -> List[ServeJob]:
        out: List[ServeJob] = []
        if limit <= 0:
            return out
        with self._lock:
            for tier in self._tiers.values():
                for name, dq in list(tier.items()):
                    keep: deque = deque()
                    while dq:
                        j = dq.popleft()
                        if len(out) < limit and j.join_key == key:
                            out.append(j)
                        else:
                            keep.append(j)
                    tier[name] = keep
            self._n -= len(out)
        return out

    def remove(self, job_id: str) -> Optional[ServeJob]:
        """Pull a specific queued job (the queued-cancel path)."""
        with self._lock:
            for tier in self._tiers.values():
                for name, dq in tier.items():
                    for j in dq:
                        if j.job_id == job_id:
                            dq.remove(j)
                            self._n -= 1
                            return j
        return None


class ServeDaemon:
    """See the module docstring. Scheduling (:meth:`step`) and admission
    (:meth:`admit`) are plain methods so tests drive them in-process;
    :meth:`serve_forever` adds the socket front-end and the scheduler
    thread for the real daemon."""

    def __init__(self, opts: ServeOptions,
                 console: Callable[[str], None] = print):
        if opts.queue_depth < 1:
            raise ValueError(f"--queue-depth must be >= 1, "
                             f"got {opts.queue_depth}")
        if opts.max_join < 1:
            raise ValueError(f"--max-join must be >= 1, "
                             f"got {opts.max_join}")
        if opts.job_retries < 0:
            raise ValueError(f"--job-retries must be >= 0, "
                             f"got {opts.job_retries}")
        from g2vec_tpu_torch.device import resolve_device

        # No card, no daemon: raise before any state is touched.
        resolve_device(opts.device)
        self.opts = opts
        self.console = console
        self._jobs_dir = os.path.join(opts.state_dir, "jobs")
        self._results_dir = os.path.join(opts.state_dir, "results")
        self._spool_dir = os.path.join(opts.state_dir, "spool")
        for d in (self._jobs_dir, self._results_dir, self._spool_dir):
            os.makedirs(d, exist_ok=True)
        self._ckpt_dir = os.path.join(opts.state_dir, "ckpt")
        #: Per-replica migration secret: ``requeue``/``submitted_at`` on
        #: a submit are honored only when the payload carries this token
        #: (see _trusted_requeue). It lives as a 0600 file in the state
        #: dir, so possession proves filesystem access to THIS replica's
        #: durable state — the router qualifies (it co-hosts the state
        #: dirs and fences/migrates their journals), a network client
        #: holding the shared fleet auth_token does not. Kept across
        #: relaunches so a failover racing a relaunch stays consistent.
        self._relay_token = self._load_relay_token()
        #: The query plane's read substrate: bundles published under
        #: <state>/inventory/<job_id>/<variant>/ (plus an optional
        #: --inventory-dir of solo bundles), memory-mapped behind a
        #: byte-budgeted LRU. The catalog rebuilds itself from disk on
        #: demand, so boot needs no replay.
        self._inventory_dir = os.path.join(opts.state_dir, "inventory")
        roots = [self._inventory_dir]
        if opts.inventory_dir:
            roots.append(opts.inventory_dir)
        self.catalog = inventory.InventoryCatalog(
            roots, budget_bytes=opts.inventory_budget_bytes)
        #: Cached scan_bundles view for query resolution. This daemon
        #: is the only writer of its inventory root, so the cache is
        #: exact between publishes: every publish/republish resets it,
        #: and any resolution MISS rescans before erroring (which also
        #: picks up bundles dropped into an external --inventory-dir).
        #: Whole-dict swaps are GIL-atomic; no lock needed.
        self._inv_known: Dict[str, str] = {}
        self.qcache = inventory.QueryCache(opts.query_cache_entries)
        self.metrics = MetricsWriter(opts.metrics_jsonl, append=True)
        self.engine = ResidentEngine(cache_dir=opts.cache_dir)
        #: tenant -> TenantQuota, parsed once; immutable after init
        #: (ValueError on a bad spec surfaces at construction, not on
        #: the first unlucky tenant's submit).
        self._quotas = parse_tenant_quotas(opts.tenant_quotas)
        self._queue = _FairQueue(
            opts.queue_depth, aging_s=opts.aging_s,
            weights={t: q.weight for t, q in self._quotas.items()})
        #: Lazily-built per-tenant token buckets. Admission runs on
        #: per-connection threads, and a bucket's refill+take must be
        #: one atomic step or two concurrent submits both spend the
        #: last token.
        self._buckets: Dict[str, TokenBucket] = {}  # guarded-by: _tenant_lock
        self._tenant_lock = threading.Lock()
        #: Recent per-job service times (batch wall / jobs in batch) —
        #: the evidence behind the shed estimate. Bounded so the
        #: estimate tracks the CURRENT workload mix.
        self._service_times: "deque[float]" = deque(maxlen=32)  # guarded-by: _lock
        #: Per-tenant SLO ledger (admitted/done/shed/quota_rejected/
        #: failed/cancelled/deadline_exceeded) for /status and the
        #: router's fleet aggregation.
        self._tenant_stats: Dict[str, "Counter[str]"] = {}  # guarded-by: _lock
        self._defaults = G2VecConfig(device=opts.device)
        #: In-flight jobs and the lifecycle counters below are touched
        #: from the scheduler thread AND per-connection threads (admit,
        #: cancel_job, /status) — every mutation under _lock; the
        #: lock-discipline checker (analyze/locks.py) enforces it.
        self._running: Dict[str, ServeJob] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = False       # racy-read bool by design: writers
        #                            # converge, readers only see it late
        # guarded-by: _lock
        self._state_counts: "Counter[str]" = Counter()
        self._t0 = time.time()
        self._serial = 0             # guarded-by: _lock
        self._batches = 0            # scheduler-thread only
        self.jobs_done = 0           # guarded-by: _lock
        self.jobs_failed = 0         # guarded-by: _lock
        self._last_beat = self._t0   # scheduler liveness, see /status
        self.tcp_addr: Optional[Tuple[str, int]] = None
        #: idem_key -> job_id for every job this state dir has seen
        #: (journaled, running, or terminally recorded) — the dedup table
        #: behind exactly-once acks. Rebuilt from disk at boot so a
        #: relaunch keeps refusing duplicates it acked in a past life.
        #: guarded-by: _idem_lock — admit() runs on per-connection
        #: threads, and lookup + reservation must be one atomic step or
        #: two concurrent same-key submits both miss the table and run.
        self._idem: Dict[str, str] = {}
        self._idem_lock = threading.Lock()
        self._load_idem_table()
        #: Leadership-fencing state (serve/leader.py). The highest
        #: router epoch this state dir has EVER witnessed, persisted so
        #: a relaunch keeps rejecting a zombie ex-leader's commands;
        #: a mutating op carrying a lower epoch gets a structured
        #: ``stale_epoch`` reject in _handle_conn. Epoch-less payloads
        #: (single-router fleets, degraded-mode clients) always pass.
        self._epoch_path = os.path.join(opts.state_dir,
                                        leader.ROUTER_EPOCH_FILE)
        # guarded-by: _epoch_lock
        self._router_epoch = leader.read_epoch_file(self._epoch_path)
        self._epoch_lock = threading.Lock()
        #: Fence-marker latch: flips True once, on first sighting of
        #: <state>/fenced (racy-read bool like _draining — writers
        #: converge, readers only see it late, and "late" here means
        #: one extra marker stat()).
        self._quarantined = False
        if opts.fault_plan:
            from g2vec_tpu_torch.resilience.faults import install_plan

            install_plan(opts.fault_plan)
        self._recover_journal()

    def _load_idem_table(self) -> None:
        import json

        for d, extract in ((self._jobs_dir,
                            lambda r: r.get("payload", {}).get("idem_key")),
                           (self._results_dir,
                            lambda r: r.get("idem_key"))):
            for fn in os.listdir(d):
                if not fn.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(d, fn)) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                key = extract(rec)
                if isinstance(key, str) and key:
                    # analyze: allow[lock-discipline] boot-time rebuild,
                    # runs from __init__ before any connection thread
                    self._idem[key] = rec.get("job_id", fn[:-5])

    def _load_relay_token(self) -> str:
        """Load (or mint, 0600) ``<state-dir>/relay_token``."""
        path = os.path.join(self.opts.state_dir, "relay_token")
        try:
            with open(path) as f:
                tok = f.read().strip()
            if tok:
                return tok
        except OSError:
            pass
        tok = secrets.token_hex(16)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(tok)
        return tok

    def _trusted_requeue(self, payload: dict) -> bool:
        """Is this submit the router's own journal-migration resubmit?
        Only then are ``requeue`` (skip the tenant-quota and shed gates)
        and ``submitted_at`` (deadline-clock continuity) honored. Trust
        is possession of this replica's ``relay_token``; the shared
        fleet ``auth_token`` proves nothing here — every client has it,
        and a client that could forge requeue would bypass the very SLO
        gates tenancy exists for (and forward-date its own deadline)."""
        if not payload.get("requeue"):
            return False
        tok = payload.get("relay_token")
        return isinstance(tok, str) \
            and hmac.compare_digest(tok, self._relay_token)

    # ---- leadership fencing ----------------------------------------------

    def _observe_epoch(self, payload: dict) -> Optional[dict]:
        """The fencing-epoch gate for mutating ops.

        A payload carrying ``router_epoch`` >= the highest epoch this
        state dir has witnessed advances (and persists) the watermark
        and passes; a LOWER epoch means the sender lost the leadership
        lease to a successor — return the structured ``stale_epoch``
        reject so the zombie learns it must stop trusting its own
        failure detector. Absent/0 epochs always pass: single-router
        fleets and degraded-mode clients carry none, and this gate must
        be inert for them."""
        e = payload.get("router_epoch")
        if not isinstance(e, int) or isinstance(e, bool) or e <= 0:
            return None
        with self._epoch_lock:
            cur = self._router_epoch
            if e >= cur:
                if e > cur:
                    self._router_epoch = e
                    leader.write_epoch_file(self._epoch_path, e)
                return None
        self.metrics.emit("stale_epoch", op=payload.get("op"),
                          got_epoch=e, seen_epoch=cur, side="daemon")
        return {"event": "rejected", "error": "stale_epoch",
                "got_epoch": e, "seen_epoch": cur,
                "detail": f"router epoch {e} is stale (this replica has "
                          f"seen {cur}); the leadership lease moved on"}

    def _fenced(self) -> bool:
        """Has the leader fenced this replica (``<state>/fenced``)?

        Checked at every admission and at the trainers' shard/superstep
        boundaries. Marker presence alone quarantines — a torn marker
        reads as epoch 0, still fenced — because the marker only exists
        when a journal migration is underway and running on means
        double execution. First sighting emits ``quarantine`` and
        latches; the marker's epoch also advances the persisted
        watermark so the fencing leader's successor is never stale."""
        ep = leader.read_fence_marker(self.opts.state_dir)
        if ep is None:
            return False
        if not self._quarantined:
            self._quarantined = True
            with self._lock:
                parked = len(self._running)
            parked += self._queue.depth()
            with self._epoch_lock:
                if ep > self._router_epoch:
                    self._router_epoch = ep
                    leader.write_epoch_file(self._epoch_path, ep)
            self.metrics.emit("quarantine", epoch=ep, parked=parked)
            self.console(f"[serve] fenced at epoch {ep}: admission "
                         f"closed, in-flight work parks at the next "
                         f"boundary, no further results/inventory "
                         f"publish ({parked} job(s) stay journaled)")
        return True

    # ---- admission --------------------------------------------------------

    def _new_job_id(self) -> str:
        # admit() runs on per-connection threads: an unlocked increment
        # can hand two concurrent keyless submits the same serial.
        with self._lock:
            self._serial += 1
            serial = self._serial
        return f"j{serial:04d}-{uuid.uuid4().hex[:8]}"

    def _plan_job(self, payload: dict, job_id: Optional[str] = None,
                  submitted_at: Optional[float] = None) -> ServeJob:
        """Validate a submit payload into a ServeJob (raises ValueError /
        ManifestError naming the problem — rejection happens at admission,
        never mid-batch)."""
        if not isinstance(payload, dict):
            raise ValueError(
                f"submit payload must be an object, got "
                f"{type(payload).__name__}")
        tenant = payload.get("tenant", "default")
        if not isinstance(tenant, str) or not tenant \
                or len(tenant) > _TENANT_MAX:
            raise ValueError(f"'tenant' must be a 1-{_TENANT_MAX} char "
                             f"string, got {tenant!r}")
        priority = payload.get("priority", "batch")
        if priority not in PRIORITIES:
            raise ValueError(f"'priority' must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        deadline_s = payload.get("deadline_s")
        if deadline_s is not None:
            if not isinstance(deadline_s, (int, float)) \
                    or isinstance(deadline_s, bool) or deadline_s <= 0:
                raise ValueError(f"'deadline_s' must be a positive number, "
                                 f"got {deadline_s!r}")
            deadline_s = float(deadline_s)
        idem_key = payload.get("idem_key")
        if idem_key is not None:
            if not isinstance(idem_key, str) or not idem_key \
                    or len(idem_key) > MAX_IDEM_KEY:
                raise ValueError(f"'idem_key' must be a 1-{MAX_IDEM_KEY} "
                                 f"char string, got {idem_key!r}")
        jobd = payload.get("job")
        if not isinstance(jobd, dict):
            raise ValueError("submit needs a 'job' object")
        base = dict(jobd)
        variants_spec = base.pop("variants", None)
        seeds = base.pop("seeds", 0)
        cfg = config_from_job(base, self._defaults)
        # An ``update`` rides this pipeline end to end (validation, idem
        # dedup, quotas, journal, recovery) as a lane-less job.
        update = payload.get("op") == "update"
        if update:
            target, uvariant, epochs = _update_fields(
                payload, idem_key, variants_spec, seeds)
            variants = []
        elif variants_spec is not None and seeds:
            raise ValueError("job sets both 'variants' and 'seeds' — "
                             "pick one")
        elif seeds:
            if not isinstance(seeds, int) or isinstance(seeds, bool) \
                    or not (1 <= seeds <= MAX_JOB_LANES):
                raise ValueError(f"'seeds' must be an int in "
                                 f"[1, {MAX_JOB_LANES}], got {seeds!r}")
            variants = seed_sweep_variants(cfg, seeds)
        elif variants_spec is not None:
            if not isinstance(variants_spec, list) or not variants_spec:
                raise ValueError("'variants' must be a non-empty list of "
                                 "variant objects")
            if len(variants_spec) > MAX_JOB_LANES:
                raise ValueError(
                    f"job has {len(variants_spec)} variants; the per-job "
                    f"cap is {MAX_JOB_LANES} (submit several jobs — the "
                    f"scheduler joins compatible ones anyway)")
            variants = [_variant_from_dict(i, o, cfg)
                        for i, o in enumerate(variants_spec)]
            names = [v.name for v in variants]
            dupes = sorted({n for n in names if names.count(n) > 1})
            if dupes:
                raise ValueError(f"duplicate variant name(s) {dupes} — "
                                 f"lane outputs would overwrite each other")
        else:
            variants = [_variant_from_dict(0, {"name": "v"}, cfg)]
        if job_id is None:
            # The id is DERIVED from the idempotency key: the same
            # submission lands on the same job_id on any daemon (journal
            # entry, ckpt cursor dirs, and result record all share the
            # name), which is what makes cross-replica failover resume
            # instead of restart.
            if idem_key:
                job_id = idem_job_id(idem_key)
            elif payload.get("job_id") is not None:
                # Keyless jobs have no derivable id, so a router
                # failover resubmit passes the journaled job_id through
                # explicitly — the migrated checkpoint cursors and the
                # client's poll handle keep their names.
                explicit = payload["job_id"]
                if not isinstance(explicit, str) \
                        or not _JOB_ID_RE.fullmatch(explicit):
                    raise ValueError(
                        f"'job_id' must match {_JOB_ID_RE.pattern!r}, "
                        f"got {explicit!r}")
                job_id = explicit
            else:
                job_id = self._new_job_id()
        # Never journal the admission secrets or relay metadata: raw is
        # persisted verbatim to <state>/jobs/*.json (and re-sent on
        # failover, where the router attaches fresh auth/relay tokens
        # and the journal record's own submitted_at), so none of these
        # may outlive the admission check.
        raw = {k: v for k, v in payload.items()
               if k not in ("auth_token", "relay_token", "requeue",
                            "submitted_at", "router_epoch")}
        if submitted_at is None and self._trusted_requeue(payload):
            # Deadline-clock continuity across failover: the router's
            # journal migration resubmits with the ORIGINAL admission
            # time, so deadline_s keeps measuring from when the client
            # was acked — a replica death must never reset the clock
            # (honored only with a relay-token-proven requeue, so
            # ordinary clients cannot back- or forward-date their own
            # deadlines).
            sa = payload.get("submitted_at")
            if isinstance(sa, (int, float)) and not isinstance(sa, bool):
                submitted_at = float(sa)
        job = ServeJob(job_id=job_id, tenant=tenant,
                       cfg=cfg, variants=variants, raw=raw,
                       submitted_at=(time.time() if submitted_at is None
                                     else submitted_at),
                       priority=priority, deadline_s=deadline_s,
                       idem_key=idem_key)
        if update:
            job.update_of, job.update_variant = target, uvariant
            job.update_epochs = epochs
            # A unique join key: an update never joins an engine batch,
            # and two updates of one bundle run one after the other.
            job.join_key = ("update", job.job_id)
        else:
            job.join_key = _join_key(cfg)
        return job

    def _quota_for(self, tenant: str) -> Optional[TenantQuota]:
        return self._quotas.get(tenant, self._quotas.get("*"))

    def _tenant_count(self, tenant: str, field: str) -> None:
        with self._lock:
            self._tenant_stats.setdefault(tenant, Counter())[field] += 1

    def _service_time_s(self) -> Optional[float]:
        """Mean observed per-job service time, None before the first
        completed batch (no evidence → shed_decision never sheds)."""
        with self._lock:
            times = list(self._service_times)
        if not times:
            return None
        return sum(times) / len(times)

    def admit(self, payload: dict,
              subscriber: Optional["queue.Queue"] = None) -> dict:
        """Admission control: validate + enqueue, or reject with a
        structured error. Returns the ``accepted``/``rejected`` event.

        Beyond validity and queue capacity, two SLO gates (both AFTER
        the idempotency dedup — a duplicate of an already-accepted job
        must re-ack, never be shed):

        - **tenant token bucket** (``--tenant-quotas``): an over-rate
          tenant gets a structured ``tenant_quota`` rejection carrying
          ``retry_after_s`` — exactly when the next token exists.
        - **deadline shed** (``--shed``): a deadlined job whose
          estimated wait (queue depth × observed mean service time)
          already exceeds ``deadline_s`` gets a structured ``shed``
          rejection with ``retry_after_s`` instead of an accept that is
          contractually doomed to ``deadline_exceeded``."""
        try:
            job = self._plan_job(payload)
        except (ValueError, TypeError, ManifestError) as e:
            self.metrics.emit("job_rejected", error="bad_job",
                              detail=str(e)[:300])
            return {"event": "rejected", "error": "bad_job",
                    "detail": str(e)[:500]}
        reserved = False
        if job.idem_key is not None:
            # Exactly-once ack: if this submission (same client-generated
            # idem_key) was already accepted by this state dir — maybe in
            # a previous daemon incarnation, maybe re-routed here after a
            # failover the client never saw — never run it twice: answer
            # with the ORIGINAL job_id; if it already finished, stream
            # the durable record so the caller needn't even poll. The
            # lookup and the reservation are ONE step under _idem_lock:
            # admit() runs on per-connection threads, and an unlocked
            # check-then-insert lets two concurrent same-key submits (a
            # client retrying after an ack timeout, a failover resubmit
            # racing a sticky retry) both miss the table and both run.
            with self._idem_lock:
                orig = self._idem.get(job.idem_key)
                if orig is None:
                    self._idem[job.idem_key] = job.job_id
                    reserved = True
            if not reserved:
                return self._deduped_ack(orig, job.tenant, subscriber)
        elif isinstance(payload.get("job_id"), str) \
                and self._has_durable_trace(job.job_id):
            # Keyless failover resubmit (explicit job_id, see _plan_job)
            # that this state dir already journaled, ran, or finished —
            # e.g. a router retrying a migration whose unlink raced a
            # crash. Same exactly-once answer as the idem path.
            return self._deduped_ack(job.job_id, job.tenant, subscriber)

        def _unreserve() -> None:
            if reserved:
                with self._idem_lock:
                    self._idem.pop(job.idem_key, None)

        if self._stop.is_set() or self._draining:
            _unreserve()
            return {"event": "rejected",
                    "error": ("draining" if self._draining
                              else "shutting_down"),
                    "job_id": job.job_id}
        if self._fenced():
            # Quarantined: the leader is migrating this state dir's
            # journal. Admitting now would journal a job the migration
            # can miss — the client must go to the survivor (dedup by
            # idem key makes the retry safe).
            _unreserve()
            return {"event": "rejected", "error": "fenced",
                    "job_id": job.job_id,
                    "detail": "replica is quarantined by the router's "
                              "fence marker; resubmit to the fleet"}
        # A failover/recovery resubmission (requeue=True + this
        # replica's relay_token, set only by the router's journal
        # migration) already paid the SLO gates when it was FIRST
        # admitted — the client holds an ack. Shedding or rate-limiting
        # it now would turn a replica death into a broken admission
        # contract: the job would sit journaled on the corpse until its
        # relaunch instead of migrating to a live survivor. Capacity
        # (queue_full) still applies — a full queue is a real resource
        # bound, and the router leaves the entry journaled for the
        # corpse's own recovery in that case. A requeue flag WITHOUT
        # the token degrades to a normal submit (all gates apply) —
        # that direction is safe, and loud so a router whose token read
        # failed shows up in the log instead of silently re-gating
        # already-acked migrations.
        requeue = self._trusted_requeue(payload)
        if payload.get("requeue") and not requeue:
            self.console(f"[serve] untrusted requeue flag on "
                         f"{job.job_id} ignored (no/bad relay_token)")
        quota = self._quota_for(job.tenant) if not requeue else None
        if quota is not None:
            now = time.time()
            with self._tenant_lock:
                bucket = self._buckets.get(job.tenant)
                if bucket is None:
                    bucket = TokenBucket(quota.rate, quota.burst)
                    self._buckets[job.tenant] = bucket
                allowed = bucket.take(now)
                retry_after = 0.0 if allowed else bucket.retry_after(now)
            if not allowed:
                _unreserve()
                self._tenant_count(job.tenant, "quota_rejected")
                self.metrics.bind_job(job.job_id).emit(
                    "tenant_quota", tenant=job.tenant,
                    retry_after_s=round(retry_after, 3))
                return {"event": "rejected", "error": "tenant_quota",
                        "tenant": job.tenant, "job_id": job.job_id,
                        "retry_after_s": round(retry_after, 3),
                        "detail": f"tenant {job.tenant!r} is over its "
                                  f"{quota.rate}/s rate limit "
                                  f"(burst {quota.burst:g})"}
        if self.opts.shed and not requeue:
            service = self._service_time_s()
            queued = self._queue.depth()
            retry_after = shed_decision(job.deadline_s, queued, service)
            if retry_after is not None:
                _unreserve()
                est_wait = queued * service
                self._tenant_count(job.tenant, "shed")
                self.metrics.bind_job(job.job_id).emit(
                    "shed", tenant=job.tenant,
                    retry_after_s=round(retry_after, 3),
                    est_wait_s=round(est_wait, 3))
                return {"event": "rejected", "error": "shed",
                        "tenant": job.tenant, "job_id": job.job_id,
                        "retry_after_s": round(retry_after, 3),
                        "est_wait_s": round(est_wait, 3),
                        "detail": f"estimated wait {est_wait:.1f}s "
                                  f"({queued} queued x {service:.2f}s/job) "
                                  f"exceeds deadline_s={job.deadline_s:g}"}
        job.subscriber = subscriber
        try:
            self._queue.push(job)
        except QueueFull:
            _unreserve()
            self.metrics.bind_job(job.job_id).emit(
                "job_rejected", error="queue_full", tenant=job.tenant)
            return {"event": "rejected", "error": "queue_full",
                    "detail": f"admission queue is at its "
                              f"--queue-depth cap ({self.opts.queue_depth})",
                    "queue_depth": self.opts.queue_depth,
                    "job_id": job.job_id}
        self._journal(job)
        self._tenant_count(job.tenant, "admitted")
        self._job_state(job.job_id, "queued", tenant=job.tenant,
                        priority=job.priority)
        self.metrics.bind_job(job.job_id).emit(
            "job_accepted", tenant=job.tenant, n_lanes=len(job.variants),
            priority=job.priority, queued=self._queue.depth())
        return {"event": "accepted", "job_id": job.job_id,
                "tenant": job.tenant, "n_lanes": len(job.variants),
                "priority": job.priority,
                "state_dir": self.opts.state_dir}

    def _deduped_ack(self, job_id: str, tenant: str,
                     subscriber: Optional["queue.Queue"]) -> dict:
        """The exactly-once duplicate answer: ack the ORIGINAL job_id,
        and if it already finished stream the durable record."""
        self.metrics.bind_job(job_id).emit("job_deduped", tenant=tenant)
        resp = {"event": "accepted", "job_id": job_id,
                "tenant": tenant, "deduped": True,
                "state_dir": self.opts.state_dir}
        if subscriber is not None:
            rec = self._read_result(job_id)
            if rec is not None:
                subscriber.put(rec)
            subscriber.put(None)
        return resp

    def _has_durable_trace(self, job_id: str) -> bool:
        """Whether this state dir already owns ``job_id`` — journaled
        (queued or running survives a relaunch), running, or terminally
        recorded. The keyless analogue of an _idem hit."""
        if os.path.exists(os.path.join(self._jobs_dir,
                                       f"{job_id}.json")) \
                or os.path.exists(os.path.join(self._results_dir,
                                               f"{job_id}.json")):
            return True
        with self._lock:
            return job_id in self._running

    # ---- journal / crash recovery ----------------------------------------

    def _journal(self, job: ServeJob) -> None:
        write_json_atomic(
            os.path.join(self._jobs_dir, f"{job.job_id}.json"),
            {"job_id": job.job_id, "tenant": job.tenant,
             "submitted_at": job.submitted_at, "payload": job.raw})

    def _unjournal(self, job: ServeJob) -> None:
        try:
            os.unlink(os.path.join(self._jobs_dir, f"{job.job_id}.json"))
        except OSError:
            pass

    def _read_result(self, job_id: str) -> Optional[dict]:
        import json

        path = os.path.join(self._results_dir, f"{job_id}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def journal_depth(self) -> int:
        """Accepted-but-unfinished jobs on disk — what a relaunch would
        re-queue, and what the router migrates off a dead replica."""
        try:
            return sum(1 for fn in os.listdir(self._jobs_dir)
                       if fn.endswith(".json"))
        except OSError:
            return 0

    def _recover_journal(self) -> None:
        """Re-queue every journaled (accepted, unfinished) job — the
        supervisor relaunch path. Jobs whose payload no longer validates
        (input files gone) fail with a result record instead of wedging
        the daemon."""
        import json

        recs = []
        for fn in os.listdir(self._jobs_dir):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._jobs_dir, fn)) as f:
                    recs.append(json.load(f))
            except (OSError, ValueError):
                self.console(f"[serve] dropping unreadable journal {fn}")
                os.unlink(os.path.join(self._jobs_dir, fn))
        for rec in sorted(recs, key=lambda r: r.get("submitted_at", 0.0)):
            job_id = rec.get("job_id", "?")
            if os.path.exists(os.path.join(self._results_dir,
                                           f"{job_id}.json")):
                # Exactly-once: the previous daemon died in the window
                # between writing the durable result and unlinking the
                # journal entry. The job finished — re-running it would
                # duplicate work (and terminal events).
                try:
                    os.unlink(os.path.join(self._jobs_dir,
                                           f"{job_id}.json"))
                except OSError:
                    pass
                self.metrics.bind_job(job_id).emit(
                    "job_recovered_complete")
                self.console(f"[serve] journal entry {job_id} already has "
                             f"a result record; dropping (exactly-once)")
                continue
            with self._lock:
                self._serial += 1      # keep new ids monotonic-ish
            try:
                job = self._plan_job(rec["payload"], job_id=job_id,
                                     submitted_at=rec.get("submitted_at"))
                self._queue.push(job)
            except (KeyError, ValueError, TypeError, ManifestError,
                    QueueFull) as e:
                self._finish_failed(
                    ServeJob(job_id=job_id, tenant=rec.get("tenant", "?"),
                             cfg=self._defaults, variants=[],
                             raw=rec.get("payload", {}),
                             submitted_at=rec.get("submitted_at", 0.0)),
                    f"requeue failed: {type(e).__name__}: {e}",
                    classified="fatal")
                continue
            self._job_state(job_id, "queued", tenant=job.tenant,
                            priority=job.priority, recovered=True)
            self.metrics.bind_job(job_id).emit("job_requeued",
                                               tenant=job.tenant)
            self.console(f"[serve] re-queued journaled job {job_id} "
                         f"(tenant {job.tenant!r})")

    # ---- job lifecycle ----------------------------------------------------

    def _job_state(self, job_id: str, state: str, **info) -> None:
        """One edge of the per-job state machine
        (queued → started → (checkpointed|resumed)* → terminal, where
        terminal ∈ {done, failed, cancelled, deadline_exceeded}; ``drained``
        marks a checkpoint-and-requeue pause, not an end state). Every edge
        lands in the metrics JSONL and the ``/status`` per-state counters.
        Runs on the scheduler thread AND connection threads (admit /
        cancel), racing the /status snapshot — hence the lock."""
        with self._lock:
            self._state_counts[state] += 1
        self.metrics.bind_job(job_id).emit("job_state", state=state, **info)

    def _cleanup_ckpt(self, job_id: str) -> None:
        """Drop a terminal job's streaming cursor directories (one per
        lane, named ``<job_id>.<variant>``) — a finished job must never
        leave a cursor a future same-id job could resume from."""
        for d in glob.glob(os.path.join(self._ckpt_dir, f"{job_id}.*")):
            shutil.rmtree(d, ignore_errors=True)

    def _finish_terminal(self, job: ServeJob, status: str,
                         detail: str) -> None:
        """Record a cancelled / deadline_exceeded terminal state: result
        record, journal removal, cursor cleanup, subscriber notice."""
        if self._fenced():
            # A fenced replica must not mint terminal records — the
            # survivor owns this job's fate now, and two terminal
            # states for one ack breaks exactly-once. Stay journaled.
            self._notify(job, {"event": "job_drained",
                               "job_id": job.job_id,
                               "note": "replica fenced; job stays "
                                       "journaled for migration"})
            self._notify(job, None)
            return
        record = {"event": f"job_{status}", "job_id": job.job_id,
                  "tenant": job.tenant, "status": status, "detail": detail,
                  "idem_key": job.idem_key,
                  "submitted_at": job.submitted_at,
                  "finished_at": time.time()}
        write_json_atomic(
            os.path.join(self._results_dir, f"{job.job_id}.json"), record)
        self._unjournal(job)
        self._cleanup_ckpt(job.job_id)
        with self._lock:
            self.jobs_failed += 1
        self._tenant_count(job.tenant, status)
        self._job_state(job.job_id, status, detail=detail)
        self._notify(job, record)
        self._notify(job, None)

    def cancel_job(self, job_id: str) -> dict:
        """Client-initiated cancel. A queued job dies immediately; a
        running job gets its cancel flag set and the trainers' check hook
        raises JobCancelled at the next shard/chunk boundary."""
        queued = self._queue.remove(job_id)
        if queued is not None:
            self._finish_terminal(queued, "cancelled",
                                  "cancelled while queued")
            return {"event": "cancelled", "job_id": job_id,
                    "where": "queued"}
        with self._lock:
            running = self._running.get(job_id)
        if running is not None:
            running.cancel_ev.set()
            self.metrics.bind_job(job_id).emit("job_cancel_requested")
            return {"event": "cancelling", "job_id": job_id,
                    "where": "running",
                    "note": "cooperative — takes effect at the next "
                            "shard/chunk boundary"}
        return {"event": "error", "error": f"unknown job {job_id!r} "
                                           f"(not queued, not running)"}

    def _begin_drain(self, source: str) -> None:
        """Graceful drain: stop admitting, let the in-flight batch hit its
        next boundary (where DrainRequested checkpoints streaming jobs and
        leaves everything journaled), then exit 0. Idempotent."""
        if self._draining:
            return
        self._draining = True
        self.metrics.emit("drain_begin", source=source,
                          queued=self._queue.depth(),
                          running=len(self._running))
        self.console(f"[serve] draining ({source}): admission closed, "
                     f"in-flight jobs checkpoint at the next boundary")
        from g2vec_tpu_torch.resilience.faults import fault_point

        try:
            fault_point("drain")
        finally:
            self._stop.set()

    # ---- scheduling / execution ------------------------------------------

    def step(self, timeout: float = 0.2) -> int:
        """One scheduling cycle: pop the next job (tenant-fair), join every
        shape-compatible queued job into the same engine batch, execute,
        route results. Returns the number of jobs completed (0 = idle)."""
        if self._fenced():
            # Quarantined: leave the queue journaled and untouched for
            # the migration; starting a batch now is double execution.
            time.sleep(min(timeout, 0.2))
            return 0
        job = self._queue.pop(timeout=timeout)
        if job is None:
            return 0
        batch = [job] + self._queue.take_compatible(
            job.join_key, self.opts.max_join - 1)
        # Pre-execution lifecycle filter: a job cancelled or past its
        # deadline while queued terminates here, without costing a lane.
        live: List[ServeJob] = []
        for j in batch:
            if j.cancel_ev.is_set():
                self._finish_terminal(j, "cancelled",
                                      "cancelled while queued")
            elif j.deadline_expired():
                self._finish_terminal(
                    j, "deadline_exceeded",
                    f"deadline_s={j.deadline_s} elapsed while queued")
            else:
                live.append(j)
        if not live:
            return 0
        if job.update_of is not None:
            # Its join key is unique, so the batch is this job alone.
            return self._run_update_job(job)
        return self._run_jobs(live)

    def _notify(self, job: ServeJob, event: Optional[dict]) -> None:
        q = job.subscriber
        if q is not None:
            q.put(event)

    def _run_jobs(self, batch: List[ServeJob]) -> int:
        self._batches += 1
        bid = self._batches
        with self._lock:
            self._running.update({j.job_id: j for j in batch})
        merged: List[LaneVariant] = []
        lane_jobs: List[str] = []
        lane_owner: List[Tuple[ServeJob, LaneVariant]] = []
        for j in batch:
            for v in j.variants:
                merged.append(dataclasses.replace(
                    v, index=len(merged), name=f"{j.job_id}.{v.name}"))
                lane_jobs.append(j.job_id)
                lane_owner.append((j, v))
        spool = os.path.join(self._spool_dir, f"batch{bid}")
        exec_cfg = dataclasses.replace(
            batch[0].cfg, result_name=os.path.join(spool, "out"),
            metrics_jsonl=None, manifest=None, batch_seeds=0)
        if exec_cfg.train_mode == "streaming":
            # Durable streaming: every lane checkpoints its cursor under
            # <state-dir>/ckpt/<job_id>.<variant> and resumes from it on a
            # journal re-queue (the lane names are restart-stable).
            exec_cfg = dataclasses.replace(
                exec_cfg, checkpoint_dir=self._ckpt_dir, resume=True)
        self.metrics.emit("batch_start", batch=bid,
                          jobs=[j.job_id for j in batch],
                          n_lanes=len(merged))
        for j in batch:
            self._job_state(j.job_id, "started", batch=bid,
                            attempt=j.attempts)
            self._notify(j, {"event": "started", "job_id": j.job_id,
                             "batch": bid, "joined_jobs": len(batch),
                             "n_lanes": len(j.variants)})

        def check() -> None:
            """Cooperative-interruption hook (resilience/lifecycle.py):
            the trainers call this at shard/chunk boundaries, the only
            points where stopping leaves a consistent, checkpointable
            state."""
            if self._draining:
                raise DrainRequested(detail="daemon drain")
            if self._fenced():
                # Self-quarantine park: the batch checkpoints at this
                # boundary and every job stays journaled — the fenced
                # replica must never finish work whose journal the
                # leader is migrating to a survivor.
                raise DrainRequested(detail="fenced by router")
            now = time.time()
            for j in batch:
                if j.cancel_ev.is_set():
                    raise JobCancelled(j.job_id)
                if j.deadline_expired(now):
                    raise JobDeadlineExceeded(
                        j.job_id, detail=f"deadline_s={j.deadline_s}")

        def lifecycle(job_id: str, state: str, info: dict) -> None:
            self._job_state(job_id, state,
                            **{k: info[k] for k in ("epoch", "shard", "done")
                               if k in info})

        t0 = time.time()
        try:
            res = self.engine.execute(exec_cfg, merged,
                                      console=self.console,
                                      metrics=self.metrics,
                                      lane_jobs=lane_jobs,
                                      check=check, lifecycle=lifecycle)
        except JobInterrupted as e:
            self._handle_interrupt(batch, e, bid, spool)
            return 0
        except BaseException as e:  # noqa: BLE001 — classified below
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            from g2vec_tpu_torch.resilience.supervisor import (
                classify_exception)

            verdict = classify_exception(e)
            err = f"{type(e).__name__}: {e}"[:500]
            self.console(f"[serve] batch {bid} failed ({verdict}): {err}")
            for j in batch:
                self._fail_or_requeue(j, err, verdict)
            shutil.rmtree(spool, ignore_errors=True)
            with self._lock:
                for j in batch:
                    self._running.pop(j.job_id, None)
            return 0

        wall = time.time() - t0
        if self._fenced():
            # The marker landed after the last boundary check but
            # before the terminal write: publishing now would hand the
            # client a result the survivor may also produce. Park the
            # whole batch exactly as a drain would — journaled, no
            # record, no inventory — and let idem dedup on the survivor
            # keep the accounting exactly-once.
            shutil.rmtree(spool, ignore_errors=True)
            for j in batch:
                self._job_state(j.job_id, "drained", batch=bid)
                self._notify(j, {"event": "job_drained",
                                 "job_id": j.job_id,
                                 "note": "replica fenced; job stays "
                                         "journaled for migration"})
                self._notify(j, None)
            with self._lock:
                for j in batch:
                    self._running.pop(j.job_id, None)
            return 0
        # The shed estimator's evidence: one completed batch contributes
        # its per-job share of the wall (joined jobs amortize the batch).
        with self._lock:
            self._service_times.append(wall / max(1, len(batch)))
        by_job: Dict[str, Dict] = {}
        for (j, v), lane in zip(lane_owner, res.lanes):
            outs = self._route_outputs(j, v, lane)
            self._publish_inventory(j, v, lane)
            by_job.setdefault(j.job_id, {})[v.name] = {
                "outputs": outs, "stop_epoch": len(lane.train_history),
                "acc_val": lane.acc_val}
            self._notify(j, {"event": "lane_done", "job_id": j.job_id,
                             "variant": v.name, "outputs": outs,
                             "acc_val": lane.acc_val})
        shutil.rmtree(spool, ignore_errors=True)
        now = time.time()
        for j in batch:
            record = {"event": "job_done", "job_id": j.job_id,
                      "tenant": j.tenant, "status": "done",
                      "idem_key": j.idem_key,
                      "variants": by_job.get(j.job_id, {}),
                      "batch": bid, "joined_jobs": len(batch),
                      "batch_wall_seconds": round(wall, 3),
                      "latency_seconds": round(now - j.submitted_at, 3),
                      "submitted_at": j.submitted_at, "finished_at": now}
            write_json_atomic(
                os.path.join(self._results_dir, f"{j.job_id}.json"), record)
            self._unjournal(j)
            self._cleanup_ckpt(j.job_id)
            with self._lock:
                self.jobs_done += 1
            self._tenant_count(j.tenant, "done")
            self._job_state(j.job_id, "done", batch=bid)
            self.metrics.bind_job(j.job_id).emit(
                "job_done", tenant=j.tenant, batch=bid,
                joined_jobs=len(batch),
                latency_seconds=record["latency_seconds"])
            self._notify(j, record)
            self._notify(j, None)
        with self._lock:
            for j in batch:
                self._running.pop(j.job_id, None)
        self.console(f"[serve] batch {bid}: {len(batch)} job(s), "
                     f"{len(merged)} lane(s) in {wall:.2f}s "
                     f"({res.runs_per_hour:.0f} runs/hour)")
        return len(batch)

    def _handle_interrupt(self, batch: List[ServeJob], exc: JobInterrupted,
                          bid: int, spool: str) -> None:
        """A cooperative interruption surfaced from the trainers.

        - DrainRequested: every job in the batch stays journaled (streaming
          lanes just checkpointed their cursors); the restart re-queues and
          resumes them. No terminal record is written — the job is paused,
          not over.
        - JobCancelled / JobDeadlineExceeded: the culprit job (named by
          ``exc.job_id``) terminates; innocent batch-mates re-queue WITHOUT
          an attempt charge — they did nothing wrong, the batch did.
        """
        shutil.rmtree(spool, ignore_errors=True)
        if isinstance(exc, DrainRequested):
            for j in batch:
                self._job_state(j.job_id, "drained", batch=bid)
                self._notify(j, {"event": "job_drained",
                                 "job_id": j.job_id,
                                 "note": "daemon draining; job stays "
                                         "journaled and resumes on the "
                                         "next start"})
                self._notify(j, None)
            self.console(f"[serve] batch {bid} drained "
                         f"({len(batch)} job(s) checkpointed + journaled)")
        else:
            for j in batch:
                if j.job_id == exc.job_id:
                    self._finish_terminal(j, exc.reason, str(exc))
                    continue
                try:
                    self._queue.push(j)
                    self._job_state(j.job_id, "queued",
                                    requeued_after=exc.reason)
                except QueueFull:
                    self._finish_failed(
                        j, f"requeue after batch-mate "
                           f"{exc.reason} found the queue full", "fatal")
        with self._lock:
            for j in batch:
                self._running.pop(j.job_id, None)

    def _run_update_job(self, job: ServeJob) -> int:
        """One ``update`` job: the incremental engine against the target
        bundle's live generation, then the next generation's publication.
        It shares the submit lifecycle: journaled until its record lands
        (a SIGKILL replays it from the journal), parked when fenced, and
        cancel, deadline and drain are honoured at the engine's check
        boundaries."""
        with self._lock:
            self._running[job.job_id] = job
        try:
            return self._run_update_inner(job)
        finally:
            with self._lock:
                self._running.pop(job.job_id, None)

    def _run_update_inner(self, job: ServeJob) -> int:
        key, err = self._resolve_bundle(job.update_of, job.update_variant)
        if err is not None:
            self._fail_or_requeue(
                job, f"update target: {err.get('error')}: "
                     f"{err.get('detail')}", "fatal")
            return 0
        path = self._inv_known.get(key)
        self._job_state(job.job_id, "started", update_of=key,
                        attempt=job.attempts)
        self._notify(job, {"event": "started", "job_id": job.job_id,
                           "update_of": key,
                           "epochs": job.update_epochs})

        def check() -> None:
            if self._draining:
                raise DrainRequested(detail="daemon drain")
            if self._fenced():
                raise DrainRequested(detail="fenced by router")
            if job.cancel_ev.is_set():
                raise JobCancelled(job.job_id)
            if job.deadline_expired():
                raise JobDeadlineExceeded(
                    job.job_id, detail=f"deadline_s={job.deadline_s}")

        from g2vec_tpu_torch.cache import resolve_cache_tiers
        from g2vec_tpu_torch.incremental import run_update

        t0 = time.time()
        try:
            res = run_update(
                job.cfg, path,
                walk_cache=resolve_cache_tiers(self.opts.cache_dir),
                epochs=job.update_epochs, console=self.console,
                check=check,
                emit=lambda kind, **f: self.metrics.emit(
                    kind, bundle=key, job_id=job.job_id, **f))
        except JobInterrupted as e:
            if isinstance(e, DrainRequested):
                self._job_state(job.job_id, "drained", update_of=key)
                self._notify(job, {"event": "job_drained",
                                   "job_id": job.job_id,
                                   "note": "update stays journaled and "
                                           "re-runs on the next start"})
                self._notify(job, None)
            else:
                self._finish_terminal(job, e.reason, str(e))
            return 0
        except BaseException as e:  # noqa: BLE001 — classified below
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            from g2vec_tpu_torch.resilience.supervisor import (
                classify_exception)

            err_s = f"{type(e).__name__}: {e}"[:500]
            self.console(f"[serve] update {job.job_id} failed: {err_s}")
            self._fail_or_requeue(job, err_s, classify_exception(e))
            return 0
        wall = time.time() - t0
        if self._fenced():
            # Between the last check and the publication: the survivor
            # owns this update now. No pointer flip, no record.
            self._job_state(job.job_id, "drained", update_of=key)
            self._notify(job, {"event": "job_drained",
                               "job_id": job.job_id,
                               "note": "replica fenced; update stays "
                                       "journaled for migration"})
            self._notify(job, None)
            return 0
        from g2vec_tpu_torch.io.writers import write_inventory_bundle

        try:
            gen_dir = write_inventory_bundle(
                path, res.embeddings, res.genes, res.biomarker_scores,
                {"source": "update", "job_id": job.update_of,
                 "variant": job.update_variant, "tenant": job.tenant,
                 "updated_by": job.job_id, "mode": res.stats["mode"]},
                ann_nlist=self.opts.ann_nlist,
                seed_centroids=res.km_centers,
                extra_files={"delta_fingerprints.json":
                             res.fingerprints})
        except (OSError, ValueError) as e:
            # Publication is the update's deliverable (unlike a submit's
            # best-effort bundle): its failure fails the job.
            self._fail_or_requeue(
                job, f"republish failed: {type(e).__name__}: {e}"[:500],
                "retryable" if isinstance(e, OSError) else "fatal")
            return 0
        generation = os.path.basename(gen_dir)
        # As in _publish_inventory: readers map the new generation, every
        # cached answer of the old one becomes unreachable, resolution
        # rescans.
        self.catalog.invalidate(key)
        self.qcache.invalidate_bundle(key)
        self._inv_known = {}
        self.metrics.emit(
            "republish", bundle=key, generation=generation,
            mode=res.stats["mode"],
            bytes=sum(os.path.getsize(os.path.join(gen_dir, fn))
                      for fn in os.listdir(gen_dir)))
        self._emit_ann_build(key, gen_dir)
        now = time.time()
        acc = res.acc_val
        record = {"event": "job_done", "job_id": job.job_id,
                  "tenant": job.tenant, "status": "done",
                  "idem_key": job.idem_key, "update_of": key,
                  "generation": generation, "stats": res.stats,
                  "acc_val": (None if acc != acc else round(acc, 6)),
                  "wall_seconds": round(wall, 3),
                  "latency_seconds": round(now - job.submitted_at, 3),
                  "submitted_at": job.submitted_at, "finished_at": now}
        write_json_atomic(
            os.path.join(self._results_dir, f"{job.job_id}.json"), record)
        self._unjournal(job)
        self._cleanup_ckpt(job.job_id)
        with self._lock:
            self.jobs_done += 1
        self._tenant_count(job.tenant, "done")
        self._job_state(job.job_id, "done", update_of=key)
        self.metrics.emit("update", bundle=key, job_id=job.job_id,
                          generation=generation, **res.stats)
        self._notify(job, record)
        self._notify(job, None)
        self.console(f"[serve] update {job.job_id} -> {key} "
                     f"({generation}, mode={res.stats['mode']}, "
                     f"walked={res.stats['walked_rows']}) in {wall:.2f}s")
        return 1

    def _route_outputs(self, job: ServeJob, v: LaneVariant, lane) -> List[str]:
        """Move a lane's spool files to the job's requested result_name —
        a rename, so served bytes ARE the engine's lane bytes."""
        dest_dir = os.path.dirname(job.cfg.result_name)
        if dest_dir:
            os.makedirs(dest_dir, exist_ok=True)
        outs = []
        for f in lane.output_files:
            suffix = f.rsplit("_", 1)[1]        # biomarkers|lgroups|vectors
            dest = f"{job.cfg.result_name}.{v.name}_{suffix}"
            shutil.move(f, dest)
            outs.append(dest)
        return outs

    def _publish_inventory(self, job: ServeJob, v: LaneVariant,
                           lane) -> None:
        """Publish the lane's query-plane bundle under
        ``<state>/inventory/<job_id>/<variant>/``. Publication failure
        is a metrics event, never a job failure — the durable record
        and the text outputs stay the source of truth, and the bundle
        can be lazily rebuilt from them (:meth:`_republish`)."""
        from g2vec_tpu_torch.io.writers import write_inventory_bundle

        key = f"{job.job_id}/{v.name}"
        if self._fenced():
            # Belt over the _run_jobs park: a fenced replica must not
            # publish query-plane bytes the survivor will re-derive.
            self.metrics.emit("inventory", bundle=key, bytes=0,
                              outcome="skipped", error="replica fenced")
            return
        dest = os.path.join(self._inventory_dir, job.job_id, v.name)
        if lane.embeddings is None:
            self.metrics.emit("inventory", bundle=key, bytes=0,
                              outcome="skipped",
                              error="lane carried no embedding table")
            return
        try:
            gen_dir = write_inventory_bundle(
                dest, lane.embeddings, list(lane.genes),
                lane.biomarker_scores,
                {"source": "serve", "job_id": job.job_id,
                 "variant": v.name, "tenant": job.tenant},
                ann_nlist=self.opts.ann_nlist,
                # Stage-5 k-means centers seed the IVF coarse quantizer
                # for free when the engine carried them through.
                seed_centroids=getattr(lane, "km_centers", None))
        except (OSError, ValueError) as e:
            self.metrics.emit("inventory", bundle=key, bytes=0,
                              outcome="publish_failed",
                              error=f"{type(e).__name__}: {e}"[:200])
            return
        # A re-run of the same job_id replaces the bundle: drop any
        # stale mapping + cached results so readers see the new bytes,
        # and reset the resolution cache so the new key is visible
        # (and omitted-variant auto-resolve stays exact).
        self.catalog.invalidate(key)
        self.qcache.invalidate_bundle(key)
        self._inv_known = {}
        self.metrics.emit(
            "inventory", bundle=key,
            bytes=sum(os.path.getsize(os.path.join(gen_dir, fn))
                      for fn in os.listdir(gen_dir)),
            generation=os.path.basename(gen_dir),
            outcome="published")
        self._emit_ann_build(key, gen_dir)

    def _emit_ann_build(self, key: str, dest: str) -> None:
        """One ``ann_build`` event per publication, read back from the
        sealed bundle's meta.json so what is reported is what was
        actually published (including the no-index case)."""
        import json as _json

        try:
            with open(os.path.join(dest, "meta.json")) as f:
                meta = _json.load(f)
        except (OSError, ValueError):
            meta = {}
        ann = meta.get("ann")
        if ann:
            self.metrics.emit("ann_build", bundle=key,
                              nlist=ann.get("nlist"), outcome="built",
                              ms=ann.get("build_ms"),
                              seeded=ann.get("seeded"),
                              postings=meta.get("n_genes"))
        else:
            self.metrics.emit("ann_build", bundle=key, nlist=0,
                              outcome="skipped")

    def _republish(self, job_id: str, key: str) -> bool:
        """Rebuild a lost/torn/tampered bundle from the durable
        record's ``_vectors.txt`` output. Partial by design: the
        ``[2, G]`` score matrix is not recoverable from text outputs,
        so the republished bundle answers ``neighbors``/``meta`` but
        ``topk_biomarkers`` returns ``scores_unavailable``."""
        variant = key.split("/", 1)[1] if "/" in key else None
        rec = self._read_result(job_id)
        vec_path = None
        if rec is not None and variant is not None:
            outs = rec.get("variants", {}).get(variant, {}) \
                      .get("outputs", [])
            vec_path = next((p for p in outs
                             if p.endswith("_vectors.txt")), None)
        if vec_path is None or not os.path.exists(vec_path):
            self.metrics.emit("inventory", bundle=key, bytes=0,
                              outcome="republish_unavailable")
            return False
        from g2vec_tpu_torch.io.writers import write_inventory_bundle

        dest = os.path.join(self._inventory_dir, job_id, variant)
        try:
            genes, emb = inventory.read_vectors_txt(vec_path)
            # The index is rebuilt too (no seed centroids — they are
            # not recoverable from text outputs, so the deterministic
            # row seeding applies): a republished bundle must not
            # silently lose its approximate path.
            gen_dir = write_inventory_bundle(
                dest, emb, genes, None,
                {"source": "republish", "job_id": job_id,
                 "variant": variant,
                 "from": os.path.basename(vec_path)},
                ann_nlist=self.opts.ann_nlist)
        except (OSError, ValueError) as e:
            self.metrics.emit("inventory", bundle=key, bytes=0,
                              outcome="republish_failed",
                              error=f"{type(e).__name__}: {e}"[:200])
            return False
        self.catalog.invalidate(key)
        self.qcache.invalidate_bundle(key)
        self._inv_known = {}
        self.metrics.emit(
            "inventory", bundle=key,
            bytes=sum(os.path.getsize(os.path.join(gen_dir, fn))
                      for fn in os.listdir(gen_dir)),
            generation=os.path.basename(gen_dir),
            outcome="republished")
        self._emit_ann_build(key, gen_dir)
        return True

    def _fail_or_requeue(self, job: ServeJob, err: str,
                         classified: str) -> None:
        if classified == "retryable" and job.attempts < self.opts.job_retries:
            job.attempts += 1
            try:
                self._queue.push(job)
            except QueueFull:
                self._finish_failed(job, f"{err} (retry queue full)",
                                    classified)
                return
            self._job_state(job.job_id, "queued", retry=job.attempts)
            self.metrics.bind_job(job.job_id).emit(
                "job_retry", attempt=job.attempts, error=err)
            self._notify(job, {"event": "job_retry", "job_id": job.job_id,
                               "attempt": job.attempts, "error": err})
            return
        self._finish_failed(job, err, classified)

    def _finish_failed(self, job: ServeJob, err: str,
                       classified: str) -> None:
        if self._fenced():
            # Same contract as _finish_terminal: no terminal records
            # after fencing — the job stays journaled for the survivor.
            self._notify(job, {"event": "job_drained",
                               "job_id": job.job_id,
                               "note": "replica fenced; job stays "
                                       "journaled for migration"})
            self._notify(job, None)
            return
        record = {"event": "job_failed", "job_id": job.job_id,
                  "tenant": job.tenant, "status": "failed", "error": err,
                  "idem_key": job.idem_key, "classified": classified,
                  "submitted_at": job.submitted_at,
                  "finished_at": time.time()}
        write_json_atomic(
            os.path.join(self._results_dir, f"{job.job_id}.json"), record)
        self._unjournal(job)
        self._cleanup_ckpt(job.job_id)
        with self._lock:
            self.jobs_failed += 1
        self._tenant_count(job.tenant, "failed")
        self._job_state(job.job_id, "failed", classified=classified)
        self.metrics.bind_job(job.job_id).emit("job_failed", error=err,
                                               classified=classified)
        self._notify(job, record)
        self._notify(job, None)

    # ---- query plane ------------------------------------------------------

    def _resolve_bundle(self, job_id: str, variant) \
            -> Tuple[Optional[str], Optional[dict]]:
        """Resolve against the cached disk view; only a resolution
        that FAILS on the cache pays a rescan (then retries once on
        the fresh view). Keeps the warm query path free of directory
        walks without ever turning a publishable answer into an
        error."""
        key, err = inventory.resolve_bundle_key(
            self._inv_known, job_id, variant)
        if err is None:
            return key, None
        known = inventory.scan_bundles(self.catalog.roots)
        self._inv_known = known
        return inventory.resolve_bundle_key(known, job_id, variant)

    def handle_query(self, qreq: dict) -> dict:
        """The read plane: one ``query`` sub-op (inventory.QUERY_SUBOPS)
        against this replica's bundles, behind the keyed result cache.
        A torn/tampered bundle is lazily republished from the durable
        record's text outputs and the query retried once — corruption
        costs latency, never a wrong answer."""
        q = qreq.get("q")
        t0 = time.time()
        if q == "list":
            resp = {"event": "query_result", "q": "list",
                    "bundles": self.catalog.listing()}
            self.metrics.emit("query", q="list", cache="none",
                              ms=round((time.time() - t0) * 1e3, 3))
            return resp
        if q not in inventory.QUERY_SUBOPS:
            return {"event": "error", "error": "bad_query",
                    "detail": f"unknown sub-op {q!r}; expected one of "
                              f"{inventory.QUERY_SUBOPS}"}
        job_id = qreq.get("job_id")
        if not isinstance(job_id, str) or not job_id:
            return {"event": "error", "error": "bad_query",
                    "detail": "query needs a 'job_id' string"}
        key, err = self._resolve_bundle(job_id, qreq.get("variant"))
        if err is not None:
            return err
        gene = qreq.get("gene")
        if gene is not None and not isinstance(gene, str):
            return {"event": "error", "error": "bad_query",
                    "detail": f"'gene' must be a string, got {gene!r}"}
        k = qreq.get("k", 10)
        if not isinstance(k, int) or isinstance(k, bool):
            return {"event": "error", "error": "bad_query",
                    "detail": f"'k' must be an int, got {k!r}"}
        mode = qreq.get("mode", "approx")
        if mode not in inventory.QUERY_MODES:
            return {"event": "error", "error": "bad_query",
                    "detail": f"'mode' must be one of "
                              f"{inventory.QUERY_MODES}, got {mode!r}"}
        nprobe = qreq.get("nprobe", 0)
        if not isinstance(nprobe, int) or isinstance(nprobe, bool) \
                or nprobe < 0:
            return {"event": "error", "error": "bad_query",
                    "detail": f"'nprobe' must be a non-negative int, "
                              f"got {nprobe!r}"}

        def compute() -> dict:
            try:
                return inventory.run_query(self.catalog, q, key,
                                           gene=gene, k=k, mode=mode,
                                           nprobe=nprobe)
            except inventory.InventoryError as e:
                if e.code in ("torn", "tampered") \
                        and self._republish(job_id, key):
                    return inventory.run_query(self.catalog, q, key,
                                               gene=gene, k=k,
                                               mode=mode, nprobe=nprobe)
                raise

        try:
            # The generation joins the cache key: a republish flips the
            # pointer, which changes every key, which makes any cached
            # pre-flip answer structurally unreachable — the cache can
            # never serve a stale generation.
            resp, was_hit = self.qcache.get_or_put(
                inventory.cache_key(key, q, gene, k, mode, nprobe,
                                    self.catalog.generation(key)),
                compute)
        except inventory.InventoryError as e:
            self.metrics.emit("query", q=q, cache="miss", bundle=key,
                              ms=round((time.time() - t0) * 1e3, 3),
                              error=e.code)
            return {"event": "error", "error": e.code,
                    "detail": e.detail, "job_id": job_id, "bundle": key}
        out = dict(resp)
        out["event"] = "query_result"
        self.metrics.emit("query", q=q,
                          cache="hit" if was_hit else "miss", bundle=key,
                          ms=round((time.time() - t0) * 1e3, 3),
                          mode=mode, recall_mode=out.get("recall_mode"))
        return out

    def handle_fquery(self, fqreq: dict) -> dict:
        """The federated read plane, single-replica flavor: one
        ``fquery`` sub-op (inventory.FQUERY_SUBOPS) across EVERY bundle
        this replica serves. The router scatter-gathers this very
        handler across the fleet and merges; standalone daemons answer
        directly with the same shape (minus cross-replica
        attribution)."""
        t0 = time.time()
        fq = fqreq.get("fq")
        gene = fqreq.get("gene")
        if not isinstance(gene, str) or not gene:
            return {"event": "error", "error": "bad_query",
                    "detail": "fquery needs a 'gene' string"}
        k = fqreq.get("k", 50)
        if not isinstance(k, int) or isinstance(k, bool):
            return {"event": "error", "error": "bad_query",
                    "detail": f"'k' must be an int, got {k!r}"}
        mode = fqreq.get("mode", "approx")
        nprobe = fqreq.get("nprobe", 0)
        if not isinstance(nprobe, int) or isinstance(nprobe, bool) \
                or nprobe < 0:
            return {"event": "error", "error": "bad_query",
                    "detail": f"'nprobe' must be a non-negative int, "
                              f"got {nprobe!r}"}
        ref_genes = fqreq.get("ref_genes")
        if ref_genes is not None and not (
                isinstance(ref_genes, list)
                and all(isinstance(g, str) for g in ref_genes)):
            return {"event": "error", "error": "bad_query",
                    "detail": "'ref_genes' must be a list of strings"}
        if fq == "bundle_overlap" and not ref_genes:
            # Standalone convenience: derive the reference neighbor set
            # from the named bundle so a single-daemon client need not
            # run two requests. The router resolves this itself and
            # always forwards ref_genes.
            job_id = fqreq.get("job_id")
            if not isinstance(job_id, str) or not job_id:
                return {"event": "error", "error": "bad_query",
                        "detail": "bundle_overlap needs 'ref_genes' or "
                                  "a reference 'job_id'"}
            ref_key, err = self._resolve_bundle(job_id,
                                                fqreq.get("variant"))
            if err is not None:
                return err
            try:
                ref_resp = inventory.run_query(
                    self.catalog, "neighbors", ref_key, gene=gene, k=k,
                    mode=mode, nprobe=nprobe)
            except inventory.InventoryError as e:
                return {"event": "error", "error": e.code,
                        "detail": e.detail, "bundle": ref_key}
            ref_genes = ref_resp["neighbors"]
        try:
            partials = inventory.run_fquery(
                self.catalog, fq, gene, k=k, mode=mode, nprobe=nprobe,
                ref_genes=ref_genes)
        except inventory.InventoryError as e:
            self.metrics.emit("fquery", fq=fq,
                              ms=round((time.time() - t0) * 1e3, 3),
                              error=e.code)
            return {"event": "error", "error": e.code, "detail": e.detail}
        self.metrics.emit("fquery", fq=fq,
                          ms=round((time.time() - t0) * 1e3, 3),
                          bundles=len(partials))
        return {"event": "fquery_result", "fq": fq, "gene": gene,
                "k": k, "mode": mode,
                "bundles": inventory.merge_fquery(fq, partials),
                "ref_genes": ref_genes if fq == "bundle_overlap"
                else None}

    # ---- status -----------------------------------------------------------

    def status(self) -> dict:
        """The warm-state + queue inventory (the ``/status`` payload)."""
        from g2vec_tpu_torch.cache import cache_stats

        with self._lock:
            running = sorted(self._running)
            # One consistent snapshot: copying the Counter while a
            # connection thread bumps it can RuntimeError mid-iteration.
            job_states = dict(self._state_counts)
            jobs_done, jobs_failed = self.jobs_done, self.jobs_failed
            service_times = list(self._service_times)
            tenants = {t: dict(c) for t, c in self._tenant_stats.items()}
        with self._epoch_lock:
            router_epoch = self._router_epoch
        service = (round(sum(service_times) / len(service_times), 3)
                   if service_times else None)
        return {"event": "status", "pid": os.getpid(),
                "uptime_s": round(time.time() - self._t0, 1),
                "socket": self.opts.socket_path,
                "device": self.opts.device,
                "listen": (f"{self.tcp_addr[0]}:{self.tcp_addr[1]}"
                           if self.tcp_addr else None),
                "state_dir": self.opts.state_dir,
                #: Scheduler-loop liveness. Observability only — this age
                #: grows through any long batch (step() blocks in the
                #: engine), so the router's health machine keys on probe
                #: reachability, never on this number.
                "last_heartbeat_age_s": round(time.time()
                                              - self._last_beat, 3),
                "journal_depth": self.journal_depth(),
                "queued": self._queue.depth(), "running": running,
                "queued_by_priority": self._queue.depths(),
                "draining": self._draining,
                #: Leadership-fencing plane: the highest router epoch
                #: witnessed and whether the leader has quarantined
                #: this state dir (serve/leader.py fence marker).
                "router_epoch": router_epoch,
                "fenced": self._fenced(),
                "job_states": job_states,
                "queue_depth_limit": self.opts.queue_depth,
                "max_join": self.opts.max_join,
                "jobs_done": jobs_done,
                "jobs_failed": jobs_failed,
                #: Admission-SLO plane: the shed estimator's current
                #: evidence plus the per-tenant ledger the router sums
                #: into its fleet-wide /status aggregate.
                "service_time_s": service,
                "shed_enabled": self.opts.shed,
                "tenants": tenants,
                "engine": self.engine.status(),
                "cache": cache_stats(),
                "inventory": {**self.catalog.stats(),
                              "query_cache": self.qcache.stats()}}

    # ---- socket front-end -------------------------------------------------

    def _handle_conn(self, conn: "socket.socket") -> None:
        # Per-connection deadline: bounds the request read AND any later
        # send to a client that stopped reading its event stream. A
        # stalled or byte-trickling peer costs one thread for at most
        # read_deadline_s, never forever (the front-door contract,
        # applied to the UNIX listener too).
        try:
            conn.settimeout(self.opts.read_deadline_s)
        except OSError:
            pass
        max_bytes = self.opts.max_request_bytes or protocol.MAX_LINE_BYTES
        f = conn.makefile("rwb")
        try:
            try:
                first = f.readline(max_bytes + 1)
            except socket.timeout:
                return                      # stalled before a full request
            if not first:
                return
            if len(first) > max_bytes and not first.endswith(b"\n"):
                protocol.write_event(
                    f, {"event": "error", "error": "oversized_request",
                        "detail": f"request line exceeds the "
                                  f"{max_bytes}-byte bound"})
                return
            if first.startswith(b"GET "):
                self._serve_http(f, first)
                return
            import json

            try:
                req = json.loads(first)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                protocol.write_event(f, {"event": "error",
                                         "error": f"bad request: {e}"})
                return
            op = req.get("op")
            if self.opts.auth_token is not None \
                    and op in ("submit", "update", "cancel", "drain",
                               "shutdown", "query", "fquery") \
                    and req.get("auth_token") != self.opts.auth_token:
                # Tenancy is checked AT ADMISSION: a mutating op without
                # the shared secret never reaches planning or the queue.
                # ``query`` is a READ but still gated — it exposes
                # tenant embeddings/scores, not just health. status/
                # ping stay open — the router's health probes (and any
                # curl) must not need credentials.
                self.metrics.emit("auth_rejected", op=op)
                protocol.write_event(
                    f, {"event": "rejected", "error": "unauthorized",
                        "detail": f"op {op!r} requires a valid "
                                  f"'auth_token' on this listener"})
                return
            if op in ("submit", "update", "cancel", "drain", "shutdown"):
                # Fencing gate, mutating ops only: a command stamped
                # with a superseded leadership epoch comes from a
                # zombie ex-leader — reject it structurally so the
                # zombie stops fencing/migrating. Reads (status, ping,
                # result, query) stay open to everyone: a stale router
                # observing the fleet is harmless and useful.
                stale = self._observe_epoch(req)
                if stale is not None:
                    protocol.write_event(f, stale)
                    return
            if op in ("submit", "update"):
                # ``update`` is a write: it rides the submit pipeline
                # (admission, journal, streamed events).
                sub: "queue.Queue" = queue.Queue()
                resp = self.admit(req, subscriber=sub)
                protocol.write_event(f, resp)
                if resp["event"] != "accepted":
                    return
                while True:
                    ev = sub.get()
                    if ev is None:
                        break
                    protocol.write_event(f, ev)
            elif op == "status":
                protocol.write_event(f, self.status())
            elif op == "ping":
                protocol.write_event(f, {"event": "pong",
                                         "pid": os.getpid()})
            elif op == "result":
                # Durable-record lookup: the network recovery path after
                # a lost stream (client.poll_result_net) — works without
                # filesystem access to the state dir. Bounded: the
                # response honors the client's fields/max_bytes and the
                # server's --max-result-bytes cap (protocol.bound_record)
                # instead of streaming the whole record unconditionally.
                rreq = req
                job_id = rreq.get("job_id")
                if not isinstance(job_id, str) or not job_id:
                    protocol.write_event(
                        f, {"event": "error",
                            "error": "result needs a 'job_id' string"})
                else:
                    rec = self._read_result(job_id)
                    if rec is None:
                        protocol.write_event(
                            f, {"event": "pending", "job_id": job_id,
                                "journaled": os.path.exists(os.path.join(
                                    self._jobs_dir, f"{job_id}.json"))})
                    else:
                        protocol.write_event(f, protocol.bound_record(
                            rec, rreq.get("fields"),
                            rreq.get("max_bytes"),
                            self.opts.max_result_bytes
                            or protocol.MAX_LINE_BYTES))
            elif op == "query":
                qreq = req
                protocol.write_event(f, self.handle_query(qreq))
            elif op == "fquery":
                fqreq = req
                protocol.write_event(f, self.handle_fquery(fqreq))
            elif op == "cancel":
                job_id = req.get("job_id")
                if not isinstance(job_id, str) or not job_id:
                    protocol.write_event(
                        f, {"event": "error",
                            "error": "cancel needs a 'job_id' string"})
                else:
                    protocol.write_event(f, self.cancel_job(job_id))
            elif op == "drain":
                protocol.write_event(
                    f, {"event": "draining",
                        "queued": self._queue.depth(),
                        "running": len(self._running),
                        "note": "in-flight jobs checkpoint + stay "
                                "journaled; restart resumes them"})
                threading.Thread(target=self._begin_drain,
                                 args=("client",), daemon=True).start()
            elif op == "shutdown":
                protocol.write_event(
                    f, {"event": "shutting_down",
                        "queued": self._queue.depth(),
                        "note": "queued jobs stay journaled and re-queue "
                                "on the next start"})
                self._stop.set()
            else:
                protocol.write_event(f, {"event": "error",
                                         "error": f"unknown op {op!r}"})
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass      # client went away; any running job continues
        finally:
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    def _serve_http(self, f, first: bytes) -> None:
        import json

        parts = first.split()
        path = parts[1].decode("latin-1") if len(parts) >= 2 else "/"
        if path in ("/status", "/status/"):
            body = json.dumps(self.status()).encode()
            head = b"HTTP/1.0 200 OK\r\n"
        else:
            body = json.dumps({"error": f"unknown path {path!r}; "
                                        f"try /status"}).encode()
            head = b"HTTP/1.0 404 Not Found\r\n"
        f.write(head + b"Content-Type: application/json\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        f.flush()

    def serve_forever(self) -> int:
        """Bind the socket, run the scheduler thread, serve until a
        ``shutdown`` op or SIGTERM. Returns the process exit code."""
        import signal

        # Mixed interactive/batch process: query threads share the GIL
        # with training lanes, and CPython's default 5 ms switch
        # interval means a compute-bound training thread can park a
        # 2 ms query behind one-to-two 5 ms GIL holds — the whole warm
        # p99 budget lost to scheduling. 1 ms caps any single hold at
        # ~1/10 of the query budget for a ~1% bytecode-dispatch tax on
        # training (the card's kernels run off the GIL anyway). Scoped to
        # the real daemon process, not library import, so tests and
        # solo runs keep the interpreter default.
        sys.setswitchinterval(1e-3)

        def _sched():
            while not self._stop.is_set():
                try:
                    self._last_beat = time.time()
                    self.step(timeout=0.2)
                except Exception as e:  # noqa: BLE001 — daemon must live
                    self.console(f"[serve] scheduler error: "
                                 f"{type(e).__name__}: {e}")
                    self.metrics.emit("scheduler_error",
                                      error=f"{type(e).__name__}: {e}"[:300])

        sched = threading.Thread(target=_sched, name="g2v-serve-sched",
                                 daemon=True)
        sched.start()
        def _on_sigterm(*_):
            # Signal context: just flip the flags and let the scheduler /
            # accept loops do the actual drain work on their own threads.
            threading.Thread(target=self._begin_drain, args=("sigterm",),
                             daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass      # not the main thread (tests) — SIGTERM unhandled
        if os.path.exists(self.opts.socket_path):
            os.unlink(self.opts.socket_path)    # stale socket from a kill
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.opts.socket_path)
        srv.listen(16)
        srv.settimeout(0.25)
        # Pidfile: the last-resort fence target. A router that restarts
        # and cannot probe this replica (busy, wedged) must still be
        # able to kill it before launching a successor on the same
        # state dir — an unfenced zombie would race the successor on
        # the same journal. Verified against /proc cmdline by the
        # reader, so a recycled pid is never killed.
        pid_file = os.path.join(self.opts.state_dir, "serve.pid")
        with open(pid_file + ".tmp", "w") as fh:
            fh.write(f"{os.getpid()}\n")
        os.replace(pid_file + ".tmp", pid_file)
        tcp_srv = None
        if self.opts.listen:
            host, port = protocol.parse_addr(self.opts.listen)
            tcp_srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            tcp_srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            tcp_srv.bind((host, port))
            tcp_srv.listen(64)
            tcp_srv.settimeout(0.25)
            self.tcp_addr = tcp_srv.getsockname()[:2]
            # Discovery file: router/clients learn the ephemeral port
            # (port 0 requests) without parsing our stderr.
            addr_file = os.path.join(self.opts.state_dir, "tcp_addr")
            with open(addr_file + ".tmp", "w") as fh:
                fh.write(f"{self.tcp_addr[0]}:{self.tcp_addr[1]}\n")
            os.replace(addr_file + ".tmp", addr_file)

        def _accept_loop(lsock):
            while not self._stop.is_set():
                try:
                    conn, _ = lsock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=self._handle_conn, args=(conn,),
                                 name="g2v-serve-conn", daemon=True).start()

        self.metrics.emit("serve_start", pid=os.getpid(),
                          socket=self.opts.socket_path,
                          listen=(f"{self.tcp_addr[0]}:{self.tcp_addr[1]}"
                                  if self.tcp_addr else None),
                          state_dir=self.opts.state_dir,
                          queued=self._queue.depth())
        self.console(f"[serve] listening on {self.opts.socket_path}"
                     + (f" + tcp {self.tcp_addr[0]}:{self.tcp_addr[1]}"
                        if self.tcp_addr else "")
                     + f" (state {self.opts.state_dir}, queue depth "
                       f"{self.opts.queue_depth}, max join "
                       f"{self.opts.max_join})")
        tcp_thread = None
        if tcp_srv is not None:
            tcp_thread = threading.Thread(target=_accept_loop,
                                          args=(tcp_srv,),
                                          name="g2v-serve-tcp", daemon=True)
            tcp_thread.start()
        try:
            _accept_loop(srv)
        finally:
            srv.close()
            if tcp_srv is not None:
                tcp_srv.close()
                if tcp_thread is not None:
                    tcp_thread.join(timeout=2.0)
            try:
                os.unlink(self.opts.socket_path)
            except OSError:
                pass
            try:
                os.unlink(pid_file)    # clean exit: nothing to fence
            except OSError:
                pass
            sched.join(timeout=600.0)
            self.metrics.emit("serve_stop", jobs_done=self.jobs_done,
                              jobs_failed=self.jobs_failed,
                              queued=self._queue.depth())
            self.console(f"[serve] stopped ({self.jobs_done} job(s) done, "
                         f"{self._queue.depth()} still queued/journaled)")
            self.close()
        return 0

    def close(self) -> None:
        self._stop.set()
        self.engine.close()
        self.metrics.close()
