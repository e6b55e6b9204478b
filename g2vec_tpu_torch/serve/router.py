"""The serve fleet front door: one TCP listener over N daemon replicas.

The port's copy of ``g2vec_tpu/serve/router.py``. Its replicas are
``python -m g2vec_tpu_torch serve`` children, each with its own CUDA
context on the card (or ``--device cpu``); the router itself imports
neither torch nor jax, boots in milliseconds and never holds a CUDA
context.

- **Placement**: a consistent-hash ring over the job's join key (the
  same :func:`~g2vec_tpu_torch.config.serve_join_key` the daemon batches
  on), so shape-compatible jobs from different clients land on the same
  replica and still join one lane batch there. 64 virtual nodes per
  replica keep the key movement on a replica add or remove near 1/N.
- **Health**: a per-replica probe loop (``status`` over TCP, with a
  deadline) drives the healthy -> suspect -> dead -> rejoining machine
  of :class:`~g2vec_tpu_torch.resilience.lifecycle.ReplicaHealth`;
  probes back off exponentially for unhealthy replicas.
- **Failover**: a replica declared dead is *fenced* first (SIGKILL via
  :class:`~g2vec_tpu_torch.resilience.supervisor.ReplicaFleet`, so a
  slow-but-alive replica can never race a survivor). Then its journal
  is walked: entries with a durable result record are dropped, the rest
  have their streaming cursors copied to a survivor and are resubmitted
  there with the original idempotency key, so the survivor's dedup
  table acks them exactly once even if the router dies and retries the
  whole failover. Only then is the replica relaunched; it rejoins the
  ring once consecutive probes pass with an empty journal. A replica
  whose relaunch dies during boot (no card, say) is reported and left
  down: the router does not relaunch it in a loop.

The exactly-once argument: every routed job carries an idem key
(client-supplied or router-minted); the job_id is derived from it, so
journal entries, cursor checkpoints and result records keep their names
across replicas; any resubmission (client retry after a lost ack,
router failover, a failover repeated after a router crash) therefore
dedups against an admission table, reconciles against a result record,
or resumes the same cursor.
"""
from __future__ import annotations

import bisect
import dataclasses
import glob
import hashlib
import json
import os
import shutil
import socket
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from g2vec_tpu_torch.config import G2VecConfig, config_from_job, serve_join_key
from g2vec_tpu_torch.resilience.lifecycle import ReplicaHealth, ScalingPolicy
from g2vec_tpu_torch.resilience.supervisor import ReplicaFleet
from g2vec_tpu_torch.serve import inventory, leader, protocol
from g2vec_tpu_torch.utils.metrics import MetricsWriter

#: Token-gated ops: the mutators, plus ``query``/``fquery`` — reads,
#: but ones that expose tenant embeddings/scores, not just health
#: (probes stay open).
_AUTH_OPS = ("submit", "update", "cancel", "drain_replica", "shutdown",
             "query", "fquery")


def sanitize_client_submit(req: dict) -> dict:
    """Strip the fields a client must never control from a submit
    before relaying it: ``auth_token`` (the admission secret must not
    be journaled downstream), and the router-internal migration fields
    ``requeue``/``submitted_at``/``relay_token`` — forwarded untouched,
    any tenant holding the shared fleet token could bypass the
    per-tenant quota and deadline-shed gates and forward-date its own
    deadline clock. The daemon additionally refuses those fields
    without the replica's relay_token (defense in depth); stripping
    here keeps an honest client's stale field from degrading too.
    ``router_epoch`` is stripped for the same reason: the fencing
    epoch is the ROUTER's claim of leadership — a client-supplied one
    could advance a daemon's persisted watermark and lock the real
    leader out."""
    return {k: v for k, v in req.items()
            if k not in ("auth_token", "requeue", "submitted_at",
                         "relay_token", "router_epoch")}


# ---------------------------------------------------------------------------
# Consistent hashing
# ---------------------------------------------------------------------------

class HashRing:
    """Consistent-hash ring with virtual nodes. ``lookup`` walks
    clockwise past members the caller marks ineligible, so health is an
    overlay — the ring itself only changes on add/remove, which is what
    keeps key movement minimal."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = vnodes
        self._points: List[Tuple[int, str]] = []
        self._members: set = set()

    @staticmethod
    def _h(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")

    def add(self, name: str) -> None:
        if name in self._members:
            return
        self._members.add(name)
        for i in range(self.vnodes):
            bisect.insort(self._points, (self._h(f"{name}#{i}"), name))

    def remove(self, name: str) -> None:
        self._members.discard(name)
        self._points = [p for p in self._points if p[1] != name]

    def members(self) -> List[str]:
        return sorted(self._members)

    def lookup(self, key: str, eligible=None) -> Optional[str]:
        """Owner of ``key`` among ``eligible`` members (all, if None)."""
        if not self._points:
            return None
        ok = self._members if eligible is None \
            else (self._members & set(eligible))
        if not ok:
            return None
        i = bisect.bisect_right(self._points, (self._h(key), "￿"))
        for off in range(len(self._points)):
            _, name = self._points[(i + off) % len(self._points)]
            if name in ok:
                return name
        return None


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RouterOptions:
    #: Fleet root: ``<fleet_dir>/rN/{sock,state/,serve.log}`` per replica,
    #: plus ``router_addr`` / ``router.log`` / ``router-metrics.jsonl``.
    fleet_dir: str
    replicas: int = 2
    listen: str = "127.0.0.1:0"
    #: Probe cadence for healthy replicas; unhealthy ones back off
    #: exponentially from this base (ReplicaHealth.probe_interval).
    probe_interval: float = 0.5
    #: Socket deadline on one probe — a replica that cannot answer
    #: ``status`` within this is a failed probe.
    probe_deadline: float = 2.0
    suspect_after: int = 1
    dead_after: int = 3
    rejoin_after: int = 2
    #: Shared secret: required on mutating client ops AND forwarded on
    #: every replica request (replicas are started with the same token).
    auth_token: Optional[str] = None
    read_deadline_s: float = 30.0
    max_request_bytes: int = 0
    metrics_jsonl: Optional[str] = None
    #: Extra argv appended to every replica's ``g2vec serve`` command
    #: (cache dir, queue depth, fault plans for chaos drills, ...).
    serve_argv: Tuple[str, ...] = ()
    #: Grace before SIGKILL when fencing a dead-declared replica.
    fence_grace_s: float = 1.0
    vnodes: int = 64
    #: How long a keyed submit waits for an already-journaled key's home
    #: replica to recover (or its entry to migrate) before the submit is
    #: refused with ``retry_later`` — never ring-placed, which would run
    #: the job twice.
    sticky_deadline_s: float = 120.0
    #: Byte budget for the router's OWN mmap catalog — the failover read
    #: path that answers queries for bundles whose home replica is dead
    #: (the fleet's state dirs are co-located with the router).
    inventory_budget_bytes: int = 256 << 20
    #: Server-side cap on a relayed ``result`` response (see
    #: protocol.bound_record). 0 = protocol.MAX_LINE_BYTES.
    max_result_bytes: int = 0
    #: Elastic fleet bounds: the scaling controller may shrink the
    #: active (in-ring) set to ``min_replicas`` and grow it to
    #: ``max_replicas``. 0 = track ``replicas`` — with both at 0 the
    #: fleet is static and the controller never acts (the pre-elastic
    #: behavior, and the default).
    min_replicas: int = 0
    max_replicas: int = 0
    #: Warm-pool size: spare daemons kept launched (CUDA context up,
    #: zero jobs) but OUT of the ring, so a scale-up is a ring add
    #: (~instant) instead of a cold daemon boot (tens of seconds). The
    #: pool refills in the background after each promotion while cold
    #: names remain.
    warm_spares: int = 0
    #: Canary job file (JSON payload) run through every spare right
    #: after it parks in the warm pool — OUT of the ring, result
    #: discarded. A daemon process is only process-warm at launch; the
    #: expensive part of its first real batch is the first CUDA use,
    #: the kernels' load and the dataset's parse, and on a busy host that
    #: bill lands exactly when a surge is on. The canary moves it to
    #: the spare's idle time, so promotion is a ring add in fact, not
    #: just in mechanism. None disables pre-warming.
    warmup_job: Optional[str] = None
    #: Control-loop cadence: one /status sweep of the active set, one
    #: ScalingPolicy.observe per interval (also how often the /status
    #: fleet aggregate refreshes).
    scale_interval: float = 1.0
    #: ScalingPolicy thresholds (queued jobs per active replica) and
    #: the estimated-wait trip wire — see lifecycle.ScalingPolicy for
    #: the hysteresis/cooldown semantics.
    scale_up_queue: float = 4.0
    scale_down_queue: float = 0.5
    scale_up_wait_s: float = 8.0
    #: Seed for the controller's rng (victim choice on scale-down) —
    #: a chaos run with a fixed seed drains the same replicas every run.
    scale_seed: int = 0
    #: HA control plane (serve/leader.py). ``standby=True``: do not
    #: serve; watch ``<fleet_dir>/leader.json`` and take over with
    #: epoch+1 (adopting the live fleet) once the lease expires.
    #: ``lease_ttl_s > 0`` on a primary: acquire + renew the lease and
    #: stamp every mutating replica command with the fencing epoch.
    #: Both default OFF — a 1-router fleet never writes a lease and
    #: every command goes out epoch-less (as a single router's do).
    standby: bool = False
    lease_ttl_s: float = 0.0
    #: Replicas reached through a relay or on another host: their
    #: death can never be verified from here (SIGKILL proves nothing),
    #: so failover quarantines them with a fence marker + epoch bump
    #: instead, and probe adoption keeps the externally published
    #: ``tcp_addr`` instead of the daemon's self-reported listen addr.
    remote_replicas: bool = False
    #: Join-key salting: a keyed submit may land on the least-loaded
    #: of this many ring candidates for its join key, so a single-hot-
    #: shape flash crowd spreads to a promoted spare instead of
    #: pinning one replica. 1 = the pre-salting single-owner placement.
    join_spread: int = 1


class Router:
    """Health-checked, consistent-hashing front door over a ReplicaFleet.

    Durable state lives ONLY in the replicas' state dirs (journal,
    results, cursors, idem tables) — the router itself can be SIGKILLed
    and relaunched at any point: on boot it probes each replica socket
    and either *adopts* the live daemon (pid from its status) or runs
    the same failover it would run for a mid-flight death.
    """

    def __init__(self, opts: RouterOptions,
                 console: Callable[[str], None] = print):
        self.opts = opts
        self.console = console
        os.makedirs(opts.fleet_dir, exist_ok=True)
        self.metrics = MetricsWriter(
            opts.metrics_jsonl
            or os.path.join(opts.fleet_dir, "router-metrics.jsonl"),
            append=True)
        serve_argv = list(opts.serve_argv)
        if opts.auth_token is not None:
            tok_file = os.path.join(opts.fleet_dir, "auth_token")
            with open(tok_file, "w") as fh:
                fh.write(opts.auth_token)
            os.chmod(tok_file, 0o600)
            serve_argv += ["--auth-token-file", tok_file]
        #: Elastic bounds: 0 means "track --replicas" (static fleet).
        self._min = opts.min_replicas or opts.replicas
        self._max = opts.max_replicas or opts.replicas
        if not (1 <= self._min <= self._max):
            raise ValueError(f"need 1 <= --min-replicas <= "
                             f"--max-replicas, got {self._min}.."
                             f"{self._max}")
        if opts.warm_spares < 0:
            raise ValueError(f"--warm-spares must be >= 0, "
                             f"got {opts.warm_spares}")
        if opts.join_spread < 1:
            raise ValueError(f"--join-spread must be >= 1, "
                             f"got {opts.join_spread}")
        self._elastic = self._max > self._min
        n_initial = min(max(opts.replicas, self._min), self._max)
        # The fleet is SIZED up front (specs are cheap — directories and
        # names, no processes): active replicas + every name the
        # controller could ever scale into + the warm pool's headroom.
        # Which of those names actually run is the router's call.
        self.fleet = ReplicaFleet(opts.fleet_dir,
                                  self._max + opts.warm_spares,
                                  serve_argv=serve_argv, console=console)
        self.ring = HashRing(vnodes=opts.vnodes)
        self.health: Dict[str, ReplicaHealth] = {}
        #: The in-ring replica set — exactly the ring's membership (the
        #: health machine stays an eligibility OVERLAY on top of it).
        #: Scale-up adds a name here + to the ring; scale-down drains
        #: and demotes it to the warm pool.
        self._active: set = set(self.fleet.names()[:n_initial])  # guarded-by: _hlock
        #: Launched-but-ringless spares, promotion order = FIFO. A
        #: demoted replica rejoins this pool after its drain, so the
        #: pool can temporarily exceed warm_spares — promotions reuse
        #: warm processes before cold names either way.
        self._warm: List[str] = []              # guarded-by: _hlock
        for name in self.fleet.names():
            if name in self._active:
                self.ring.add(name)
            self.health[name] = ReplicaHealth(
                name, suspect_after=opts.suspect_after,
                dead_after=opts.dead_after,
                rejoin_after=opts.rejoin_after)
        #: The scale controller (lifecycle.ScalingPolicy): observe/act
        #: runs ONLY on the scale-loop thread, so the policy object
        #: itself needs no lock; its decisions mutate _active/_warm/ring
        #: under _hlock like everyone else.
        self._policy = ScalingPolicy(
            self._min, self._max, up_queue=opts.scale_up_queue,
            down_queue=opts.scale_down_queue,
            up_wait_s=opts.scale_up_wait_s, seed=opts.scale_seed)
        #: Fleet-wide admission/SLO aggregate (queued totals, per-tenant
        #: counters, service times) refreshed by the scale loop each
        #: interval — /status serves this cache instead of paying N
        #: replica round-trips per probe.
        self._fleet_stats: dict = {}            # guarded-by: _hlock
        #: Last successful per-replica depth sample, carried through a
        #: replica's death so the controller keeps seeing its journaled
        #: backlog as pressure. Scale-loop thread only — never shared.
        self._last_replica_stats: Dict[str, dict] = {}
        #: Scale-event ledger for /status: the last event plus counters.
        self._last_scale: Optional[dict] = None  # guarded-by: _hlock
        self._scale_events: List[dict] = []     # guarded-by: _hlock
        self.scale_ups = 0                      # guarded-by: _hlock
        self.scale_downs = 0                    # guarded-by: _hlock
        #: Serializes warm-pool refills (one background refill thread
        #: at a time; acquire is non-blocking — a running refill already
        #: converges the pool).
        self._refill_lock = threading.Lock()
        #: Cold names claimed for launch but not yet active/warm — keeps
        #: a concurrent scale-up and warm refill off the same spec.
        self._pending_cold: set = set()         # guarded-by: _hlock
        self._defaults = G2VecConfig()     # identical to the daemon's
        self._hlock = threading.RLock()
        #: One lock per replica: fence → migrate → relaunch must be
        #: atomic per replica, whether the probe loop, boot_fleet, or an
        #: admin drain initiates it — two of those interleaving would
        #: fence/launch the same ReplicaSpec concurrently (and SIGKILL
        #: the other's freshly relaunched process).
        self._rep_locks = {n: threading.Lock()
                           for n in self.fleet.names()}
        #: Replicas mid-``drain_replica``: the probe loop skips them (a
        #: draining replica flaps dead→rejoining→dead and would trigger
        #: a failover that migrates the journal the drain contractually
        #: leaves in place), and _failover refuses to run on them.
        self._admin_draining: set = set()       # guarded-by: _hlock
        self._stop = threading.Event()
        #: Routing table and counters: written by the probe loop's
        #: failovers AND per-connection relay threads, snapshotted by
        #: /status — all under _hlock (the lock-discipline checker
        #: enforces every mutation site).
        # guarded-by: _hlock
        self._assigned: Dict[str, str] = {}     # job_id -> replica name
        self._requeue_latencies: List[float] = []   # guarded-by: _hlock
        self.failovers = 0                      # guarded-by: _hlock
        self.jobs_routed = 0                    # guarded-by: _hlock
        #: Per-replica view of that replica's published bundles — the
        #: failover READ path: when a bundle's home replica is dead the
        #: router maps the bundle itself (shared filesystem) and
        #: answers with the exact same inventory.run_query the daemon
        #: uses, so reads survive replica death like writes do. Each
        #: catalog is internally locked; this dict is immutable after
        #: __init__.
        self._inv_local: Dict[str, inventory.InventoryCatalog] = {
            n: inventory.InventoryCatalog(
                [os.path.join(self.fleet.replica(n).state_dir,
                              "inventory")],
                budget_bytes=opts.inventory_budget_bytes)
            for n in self.fleet.names()}
        #: job_id -> replica name, populated on first lookup. Bundle
        #: placement is sticky (a job's bundle only ever appears on its
        #: home replica's disk) and bundles are never deleted, so a
        #: POSITIVE lookup stays valid forever; only misses pay the
        #: disk scan. Plain dict: entry writes are idempotent, so
        #: GIL-atomic get/setdefault need no extra lock.
        self._owner_cache: Dict[str, str] = {}
        #: The leadership lease — None when HA is off (the default):
        #: a 1-router fleet never writes leader.json, router_epoch
        #: stays 0, and every mutating command goes out epoch-less.
        #: The LeaderLease carries its own lock; held/epoch reads are
        #: GIL-atomic snapshots.
        self._lease: Optional[leader.LeaderLease] = None
        if opts.standby or opts.lease_ttl_s > 0:
            self._lease = leader.LeaderLease(
                opts.fleet_dir,
                ttl_s=opts.lease_ttl_s or leader.DEFAULT_TTL_S)
        #: Mutating commands a replica refused because our epoch was
        #: superseded — the router-side zombie tripwire for /status.
        self.stale_rejects = 0                  # guarded-by: _hlock
        if opts.remote_replicas:
            # No spec may ever be fenced by pid: the processes live
            # behind a relay / on another host, so local kill(2) proof
            # is unobtainable and quarantine is the only fence.
            for n in self.fleet.names():
                self.fleet.replica(n).local = False
        self.tcp_addr: Optional[Tuple[str, int]] = None
        self._t0 = time.time()

    @property
    def router_epoch(self) -> int:
        """The fencing epoch stamped on mutating replica commands;
        0 = no leadership machinery (every _request/_relay_to drops
        the field so the wire payload is a single router's)."""
        return self._lease.epoch if self._lease is not None else 0

    # ---- replica I/O ------------------------------------------------------

    def _replica_addr(self, name: str) -> Optional[str]:
        return self.fleet.replica(name).addr

    def _request(self, name: str, req: dict,
                 timeout: Optional[float] = None) -> dict:
        """One request / one response to a replica (status, result,
        cancel, drain — everything but the submit relay)."""
        addr = self._replica_addr(name)
        if not addr:
            raise ConnectionError(f"replica {name} has no address yet")
        out = dict(req)
        if self.opts.auth_token is not None:
            out.setdefault("auth_token", self.opts.auth_token)
        if not out.get("router_epoch"):
            # Epoch 0 / absent = no leadership machinery: drop the
            # field so HA-off wire payloads stay byte-identical.
            out.pop("router_epoch", None)
        sock = protocol.dial(addr, timeout=timeout
                             if timeout is not None else 10.0)
        try:
            f = sock.makefile("rwb")
            protocol.write_event(f, out)
            ev = protocol.read_event(f)
            if ev is None:
                raise ConnectionError(f"replica {name} closed the stream")
            if ev.get("error") == "stale_epoch":
                self._on_stale_epoch(name, out.get("op"), ev)
            return ev
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _on_stale_epoch(self, name: str, op, ev: dict) -> None:
        """A replica refused our mutating command because our fencing
        epoch was superseded: this router lost the lease and is a
        zombie. Count + emit; the lease loop handles re-election."""
        with self._hlock:
            self.stale_rejects += 1
        self.metrics.emit("stale_epoch", op=op, replica=name,
                          side="router",
                          got_epoch=ev.get("got_epoch"),
                          seen_epoch=ev.get("seen_epoch"))
        self.console(f"[router] {name} rejected {op!r}: our epoch "
                     f"{ev.get('got_epoch')} is stale (replica has "
                     f"seen {ev.get('seen_epoch')}) — leadership moved")

    def probe(self, name: str) -> Tuple[bool, int]:
        """One health probe: (reachable, journal_depth)."""
        try:
            st = self._request(name, {"op": "status"},
                               timeout=self.opts.probe_deadline)
            if st.get("event") != "status":
                return False, 0
            if st.get("fenced"):
                # Reachable but quarantined (its fence marker is still
                # down): a fenced replica rejects every admission, so
                # letting it rejoin the ring would bounce its whole key
                # range. It stays "dead" to the health machine until a
                # verified restart clears the marker.
                return False, int(st.get("journal_depth") or 0)
            pid = st.get("pid")
            spec = self.fleet.replica(name)
            if spec.pid is None and isinstance(pid, int):
                # Remote/relayed replicas keep the externally
                # published tcp_addr file: the daemon's self-reported
                # listen addr is its DIRECT socket, and adopting it
                # would silently route around the relay (and around
                # any partition injector sitting on it).
                self.fleet.adopt(
                    name, pid,
                    None if self.opts.remote_replicas
                    else st.get("listen"),
                    local=not self.opts.remote_replicas)
            return True, int(st.get("journal_depth") or 0)
        except (OSError, protocol.ProtocolError, ValueError):
            return False, 0

    # ---- placement --------------------------------------------------------

    def _join_key_str(self, payload: dict) -> str:
        """The placement key: the daemon's batching join key, stringified.
        Raises ValueError for payloads the replica would reject — router
        admission catches garbage before it costs a forward."""
        jobd = payload.get("job")
        if not isinstance(jobd, dict):
            raise ValueError("submit needs a 'job' object")
        base = dict(jobd)
        base.pop("variants", None)
        base.pop("seeds", None)
        cfg = config_from_job(base, self._defaults)
        return repr(serve_join_key(cfg))

    def _eligible(self) -> List[str]:
        with self._hlock:
            return [n for n, h in self.health.items() if h.in_ring]

    def _ring_lookup(self, key: str, eligible) -> Optional[str]:
        # The ring mutates on scale events now; lookups take the same
        # lock as add/remove so a bisect never reads a half-built list.
        with self._hlock:
            return self.ring.lookup(key, eligible=eligible)

    def _pick_salted(self, key: str, eligible) -> Optional[str]:
        """Salted placement: the ring owner of ``key`` plus up to
        ``join_spread - 1`` salted alternates, least-loaded wins (ties
        go to the primary, so spread 1 and a calm fleet reproduce the
        pre-salting placement exactly). Load = the scale loop's last
        queued+running sample plus our own in-flight assignments, so
        a flash crowd spreads within one scale interval instead of
        pinning the primary until its queue sample catches up."""
        with self._hlock:
            primary = self.ring.lookup(key, eligible=eligible)
            if primary is None or self.opts.join_spread <= 1:
                return primary
            cands = [primary]
            for i in range(1, self.opts.join_spread):
                alt = self.ring.lookup(f"{key}#salt{i}",
                                       eligible=eligible)
                if alt is not None and alt not in cands:
                    cands.append(alt)
            if len(cands) == 1:
                return primary
            per = self._fleet_stats.get("per_replica") or {}
            assigned: Dict[str, int] = {}
            for rep in self._assigned.values():
                assigned[rep] = assigned.get(rep, 0) + 1

            def load(n: str) -> Tuple[int, int]:
                st = per.get(n) or {}
                q = st.get("queued")
                r = st.get("running")
                sampled = (q if isinstance(q, int) else 0) \
                    + (r if isinstance(r, int) else 0)
                return (sampled + assigned.get(n, 0), cands.index(n))

            return min(cands, key=load)

    def pick_replica(self, payload: dict) -> Optional[str]:
        return self._pick_salted(self._join_key_str(payload),
                                 eligible=self._eligible())

    # ---- failover ---------------------------------------------------------

    def _dead_paths(self, name: str):
        spec = self.fleet.replica(name)
        return (os.path.join(spec.state_dir, "jobs"),
                os.path.join(spec.state_dir, "results"),
                os.path.join(spec.state_dir, "ckpt"))

    def _relay_token_of(self, name: str) -> Optional[str]:
        """A replica's migration secret (``<state>/relay_token``,
        minted by the daemon at boot): attached to journal-migration
        resubmits so the survivor honors ``requeue``/``submitted_at``.
        The router can read it because it co-hosts the fleet's state
        dirs — which is exactly the trust being proven. None (file not
        there yet / unreadable) degrades the resubmit to a normal
        gated submit, never blocks it."""
        try:
            with open(os.path.join(self.fleet.replica(name).state_dir,
                                   "relay_token")) as fh:
                return fh.read().strip() or None
        except OSError:
            return None

    def _failover(self, name: str, relaunch: bool = True) -> int:
        """Fence a dead replica, migrate its journal to survivors, then
        relaunch it. Returns the number of jobs re-queued. Serialized
        per replica via _rep_locks (the probe loop, boot_fleet, and
        drain_replica connection handlers all get here), and suppressed
        outright while an admin drain owns the replica — a maintenance
        drain's journal must NOT migrate."""
        with self._rep_locks[name]:
            with self._hlock:
                if name in self._admin_draining:
                    return 0
            return self._failover_locked(name, relaunch)

    def _failover_locked(self, name: str, relaunch: bool) -> int:
        died_at = time.monotonic()
        spec = self.fleet.replica(name)
        rc = self.fleet.fence(name, grace_s=self.opts.fence_grace_s)
        if rc is None and not spec.local:
            # UNVERIFIED death: the replica is merely unreachable — it
            # may be alive across an asymmetric partition, mid-batch on
            # the very journal we are about to migrate. Split-brain
            # guard: bump the fencing epoch (so the corpse's view of
            # the world is provably stale) and drop a quarantine
            # marker in its state dir BEFORE reading the journal; the
            # partitioned daemon sees the marker at its next shard
            # boundary, parks everything journaled, and stops
            # publishing. If we ourselves lost the lease (bump() == 0
            # while HA is on), we are the zombie — no fencing rights,
            # no migration; the real leader owns this corpse.
            if self._lease is not None:
                fence_epoch = self._lease.bump()
                if fence_epoch == 0:
                    self.console(f"[router] NOT migrating {name}: "
                                 f"lease lost (we are the zombie)")
                    return 0
            else:
                fence_epoch = 0     # marker presence alone quarantines
            leader.write_fence_marker(spec.state_dir, fence_epoch)
            self.metrics.emit("fenced", replica=name, epoch=fence_epoch)
            self.console(f"[router] quarantined {name} (unverified "
                         f"death, fence epoch {fence_epoch})")
        jobs_dir, results_dir, ckpt_dir = self._dead_paths(name)
        entries = []
        if os.path.isdir(jobs_dir):
            for fn in sorted(os.listdir(jobs_dir)):
                if fn.endswith(".json"):
                    try:
                        with open(os.path.join(jobs_dir, fn)) as fh:
                            entries.append(json.load(fh))
                    except (OSError, ValueError):
                        self.console(f"[router] unreadable journal "
                                     f"{name}/{fn}; leaving for the "
                                     f"replica's own recovery")
        requeued = 0
        for rec in sorted(entries,
                          key=lambda r: r.get("submitted_at", 0.0)):
            job_id = rec.get("job_id")
            payload = rec.get("payload")
            if not isinstance(job_id, str) or not isinstance(payload, dict):
                continue
            jpath = os.path.join(jobs_dir, f"{job_id}.json")
            if os.path.exists(os.path.join(results_dir,
                                           f"{job_id}.json")):
                # Died between result write and journal unlink: the job
                # FINISHED. Reconcile, never re-run (exactly-once).
                try:
                    os.unlink(jpath)
                except OSError:
                    pass
                self.metrics.emit("failover_reconciled", job_id=job_id,
                                  from_replica=name)
                continue
            done_on = next(
                (n for n in self.fleet.names() if n != name
                 and os.path.exists(os.path.join(self._dead_paths(n)[1],
                                                 f"{job_id}.json"))),
                None)
            if done_on is not None:
                # Finished on another replica (this copy was journaled by
                # a replica whose ack was lost): resubmitting it to a
                # survivor other than that one would run it again.
                try:
                    os.unlink(jpath)
                except OSError:
                    pass
                self.metrics.emit("failover_reconciled", job_id=job_id,
                                  from_replica=name, already_on=done_on)
                continue
            dup_home = next(
                (n for n in self.fleet.names() if n != name
                 and os.path.exists(os.path.join(self._dead_paths(n)[0],
                                                 f"{job_id}.json"))),
                None)
            if dup_home is not None:
                # Double-journaled (a crash inside a previous failover's
                # resubmit-then-unlink window): the job already lives on
                # another replica. Dropping the dead copy — NOT
                # re-migrating it — is what keeps it exactly-once.
                try:
                    os.unlink(jpath)
                except OSError:
                    pass
                self.metrics.emit("failover_reconciled", job_id=job_id,
                                  from_replica=name, already_on=dup_home)
                continue
            try:
                target = self._ring_lookup(self._join_key_str(payload),
                                           eligible=[n for n in
                                                     self._eligible()
                                                     if n != name])
            except (ValueError, TypeError):
                target = None
            if target is None:
                # No survivor can take it — leave it journaled; the
                # relaunched replica re-queues it itself.
                self.metrics.emit("failover_deferred", job_id=job_id,
                                  from_replica=name)
                continue
            tgt_ckpt = self._dead_paths(target)[2]
            for d in glob.glob(os.path.join(ckpt_dir, f"{job_id}.*")):
                dst = os.path.join(tgt_ckpt, os.path.basename(d))
                # Cursor migration: the survivor resumes mid-stream from
                # the dead replica's last durable checkpoint.
                shutil.copytree(d, dst, dirs_exist_ok=True)
            # requeue=True: this job was ALREADY admitted once (the
            # client holds an ack) — the survivor must skip its tenant
            # bucket and shed gate (a chaos run showed a spike's
            # whole migrated journal bouncing off the survivor's
            # admission SLOs and dying of deadline_exceeded on the
            # corpse instead). submitted_at keeps the deadline clock
            # measuring from the ORIGINAL admission. The target's
            # relay_token is what makes the survivor believe either
            # field — clients can't set them (sanitize_client_submit
            # strips, the daemon verifies).
            out = dict(payload, op="submit", requeue=True,
                       router_epoch=self.router_epoch)
            tok = self._relay_token_of(target)
            if tok:
                out["relay_token"] = tok
            sa = rec.get("submitted_at")
            if isinstance(sa, (int, float)) and not isinstance(sa, bool):
                out["submitted_at"] = sa
            if not payload.get("idem_key"):
                # Keyless entry (submitted straight to the replica's
                # socket, no router): there is no key to derive the id
                # from, so pass the journaled job_id through explicitly
                # — otherwise the survivor mints a fresh serial id, the
                # migrated cursors (copied under the old id) are
                # orphaned, and the client's poll handle goes dark.
                out["job_id"] = job_id
            try:
                resp = self._request(target, out, timeout=30.0)
            except (OSError, protocol.ProtocolError) as e:
                self.metrics.emit("failover_error", job_id=job_id,
                                  from_replica=name, to_replica=target,
                                  error=str(e)[:200])
                continue           # journal entry stays; next pass retries
            if resp.get("event") != "accepted":
                self.metrics.emit("failover_error", job_id=job_id,
                                  from_replica=name, to_replica=target,
                                  error=str(resp)[:200])
                continue
            try:
                os.unlink(jpath)   # after the survivor journaled it —
            except OSError:        # a crash here double-journals, and the
                pass               # idem table dedups the double
            latency = time.monotonic() - died_at
            requeued += 1
            # One critical section for the whole failover record: a
            # /status racing these lines must never see the assignment
            # without the counter (or copy the latency list mid-append).
            with self._hlock:
                self._requeue_latencies.append(latency)
                self.failovers += 1
                self._assigned[job_id] = target
            self.metrics.emit("failover", job_id=job_id,
                              from_replica=name, to_replica=target,
                              deduped=bool(resp.get("deduped")),
                              latency_s=round(latency, 4))
            self.console(f"[router] failover {job_id}: {name} -> "
                         f"{target} ({latency:.2f}s after death)")
        if spec.boot_error is not None:
            # Its last boot died before it listened (no card, a broken
            # build): relaunching on every probe would only repeat that.
            # It stays down until an operator's drain_replica relaunches
            # it.
            relaunch = False
        if relaunch and spec.local and not self._stop.is_set():
            try:
                # launch() clears any fence marker on this state dir —
                # a fresh local daemon starts unquarantined.
                self.fleet.launch(name)
                self.metrics.emit("replica_relaunched", replica=name)
            except (RuntimeError, TimeoutError, OSError) as e:
                self.metrics.emit("replica_relaunch_failed", replica=name,
                                  error=str(e)[:200])
                self.console(f"[router] relaunch of {name} failed: {e}")
        # Non-local replicas are NOT relaunched (their supervisor owns
        # the process) and their fence marker stays: only a verified
        # restart on that state dir may lift the quarantine.
        return requeued

    # ---- probe loop -------------------------------------------------------

    def _probe_targets(self) -> List[str]:
        """Names worth probing: the active set plus the warm pool. Cold
        names (sized into the fleet but never launched) are skipped —
        probing them would declare them dead and fire pointless
        failover/relaunch cycles on processes that should not exist."""
        with self._hlock:
            return sorted(self._active) + list(self._warm)

    def _probe_loop(self) -> None:
        due: Dict[str, float] = {}
        while not self._stop.is_set():
            now = time.monotonic()
            for name in self._probe_targets():
                h = self.health[name]
                if now < due.get(name, 0.0):
                    continue
                with self._hlock:
                    if name in self._admin_draining:
                        # Intentionally down for maintenance: probing it
                        # would flap dead→rejoining→dead and race the
                        # drain's own fence+relaunch with a failover.
                        due[name] = time.monotonic() \
                            + self.opts.probe_interval
                        continue
                ok, jd = self.probe(name)
                with self._hlock:
                    trans = h.on_probe(ok, journal_depth=jd,
                                       now=time.time())
                    # A forward/query thread may have force_dead()ed the
                    # replica between two probes. Then on_probe sees an
                    # already-dead state and reports NO transition — but
                    # the corpse is real and nobody has fenced it. A
                    # failed probe of a dead, still-unrecovered replica
                    # must (re)trigger failover, or its journal is
                    # stranded and every sticky submit waits forever.
                    dead_unrecovered = (not ok and trans is None
                                        and h.state == "dead")
                due[name] = time.monotonic() \
                    + h.probe_interval(self.opts.probe_interval)
                if trans is not None:
                    self.metrics.emit("replica_health", replica=name,
                                      from_state=trans[0],
                                      to_state=trans[1],
                                      journal_depth=jd)
                    self.console(f"[router] {name}: {trans[0]} -> "
                                 f"{trans[1]} (journal {jd})")
                if (trans is not None and trans[1] == "dead") \
                        or dead_unrecovered:
                    self._failover(name)
            self._stop.wait(0.05)

    # ---- scaling ------------------------------------------------------

    def _collect_fleet_stats(self) -> dict:
        """One ``status`` sweep of the active set: the controller's
        input signal and the /status fleet aggregate, in one pass.
        Sums queue depths, averages observed service times, and merges
        the per-tenant admission ledgers replica-side shedding keeps."""
        with self._hlock:
            targets = sorted(self._active)
        # Prune carryover for names that left the active set, so a
        # demoted replica's last queue depth can't haunt the signal.
        for gone in set(self._last_replica_stats) - set(targets):
            del self._last_replica_stats[gone]
        queued = running = reachable = 0
        svc: List[float] = []
        tenants: Dict[str, Dict[str, int]] = {}
        per_replica: Dict[str, dict] = {}
        for name in targets:
            try:
                st = self._request(name, {"op": "status"},
                                   timeout=self.opts.probe_deadline)
            except (OSError, protocol.ProtocolError, ValueError):
                st = None
            if st is None or st.get("event") != "status":
                # Mid-death blind spot: a SIGKILLed replica answers
                # nothing while its journaled jobs still exist. Carrying
                # its last-known depth keeps the controller under
                # pressure through the outage instead of reading the
                # dead air as an idle fleet.
                last = self._last_replica_stats.get(name)
                if last:
                    queued += last["queued"]
                    running += last["running"]
                    per_replica[name] = {**last, "unreachable": True}
                continue
            reachable += 1
            q = int(st.get("queued") or 0)
            # "running" is a list of in-flight job ids in the daemon's
            # status; older builds reported a bare count. Accept both.
            rv = st.get("running")
            r = len(rv) if isinstance(rv, (list, tuple)) else int(rv or 0)
            queued += q
            running += r
            s = st.get("service_time_s")
            if isinstance(s, (int, float)):
                svc.append(float(s))
            for t, c in (st.get("tenants") or {}).items():
                if isinstance(c, dict):
                    agg = tenants.setdefault(t, {})
                    for k, v in c.items():
                        if isinstance(v, int):
                            agg[k] = agg.get(k, 0) + v
            per_replica[name] = {"queued": q, "running": r,
                                 "jobs_done": st.get("jobs_done"),
                                 "service_time_s": s}
            self._last_replica_stats[name] = {"queued": q, "running": r}
        service = sum(svc) / len(svc) if svc else None
        wait_est = (queued * service / max(1, reachable)) \
            if service is not None else None
        return {"sampled_at": round(time.time(), 3),
                "replicas_reached": reachable,
                "queued": queued, "running": running,
                "service_time_s": (round(service, 4)
                                   if service is not None else None),
                "est_wait_s": (round(wait_est, 4)
                               if wait_est is not None else None),
                "tenants": tenants, "per_replica": per_replica}

    def _scale_loop(self) -> None:
        """The control loop: one stats sweep + (if elastic) one policy
        tick per scale_interval. Runs for static fleets too — the
        sweep is what keeps the /status fleet aggregate fresh."""
        while not self._stop.is_set():
            t0 = time.monotonic()
            stats = self._collect_fleet_stats()
            with self._hlock:
                self._fleet_stats = stats
                active_n = len(self._active)
            if self._elastic:
                decision = self._policy.observe(
                    stats["queued"], active_n,
                    est_wait_s=stats.get("est_wait_s"))
                if decision == "up":
                    self._scale_up()
                elif decision == "down":
                    self._scale_down()
                else:
                    # Warm-pool refill waits for CALM (pressure below
                    # the up thresholds): a daemon boot + canary is
                    # real CPU, and spending it while the active set
                    # is fighting a surge slows the exact replicas the
                    # refill is supposed to back up. The pool refills
                    # as soon as the surge passes; until then the
                    # hole only delays the NEXT promotion.
                    pressure = stats["queued"] / max(1, active_n)
                    wait = stats.get("est_wait_s")
                    if (pressure < self.opts.scale_up_queue
                            and (wait is None
                                 or wait < self.opts.scale_up_wait_s)):
                        self._ensure_warm()
            self._stop.wait(max(0.05, self.opts.scale_interval
                                - (time.monotonic() - t0)))

    def _next_cold(self) -> Optional[str]:
        """Claim the first never-launched fleet name (not active, not
        warm, not mid-launch by another thread). The claim lives in
        ``_pending_cold`` until the caller moves the name into
        active/warm or releases it on launch failure."""
        with self._hlock:
            busy = self._active | set(self._warm) | self._pending_cold
            for name in self.fleet.names():
                if name not in busy and not self.fleet.alive(name) \
                        and self.fleet.replica(name).boot_error is None:
                    self._pending_cold.add(name)
                    return name
        return None

    def _claim_warm(self) -> Tuple[Optional[str], bool]:
        """The claim half of a scale-up in ONE critical section:
        capacity check + warm-pool pop. Returns (spare_or_None,
        capacity_available). The commit (ring/active add) happens
        after the launch, which cannot run under _hlock; the split is
        race-free because the scale-loop thread is the only caller
        that grows the active set."""
        with self._hlock:
            if len(self._active) >= self._max:
                return None, False
            return (self._warm.pop(0) if self._warm else None), True

    def _scale_up(self) -> None:
        """Add one replica to the ring: promote a warm spare (a ring
        add — near-instant) when the pool has one, else pay a cold
        daemon boot. The warm-pool refill is NOT kicked here — the
        scale loop refills once pressure reads calm again."""
        t0 = time.monotonic()
        name, capacity = self._claim_warm()
        if not capacity:
            return
        from_warm = name is not None
        if from_warm:
            self.metrics.emit("warm_spare", replica=name,
                              outcome="promoted")
        else:
            name = self._next_cold()
            if name is None:
                return
            try:
                with self._rep_locks[name]:
                    self.fleet.launch(name)
            except (RuntimeError, TimeoutError, OSError) as e:
                with self._hlock:
                    self._pending_cold.discard(name)
                self.metrics.emit("replica_relaunch_failed",
                                  replica=name, error=str(e)[:200])
                return
        reaction = time.monotonic() - t0
        with self._hlock:
            self._pending_cold.discard(name)
            self.ring.add(name)
            self._active.add(name)
            self.scale_ups += 1
            active_n = len(self._active)
            ev = {"kind": "scale_up", "replica": name,
                  "from_warm": from_warm,
                  "reaction_s": round(reaction, 4),
                  "active": active_n, "at": round(time.time(), 3)}
            self._last_scale = ev
            self._scale_events.append(ev)
        self.metrics.emit("scale_up", replica=name, from_warm=from_warm,
                          reaction_s=round(reaction, 4), active=active_n)
        self.console(f"[router] scale-up: +{name} "
                     f"({'warm' if from_warm else 'cold'}, "
                     f"{reaction:.2f}s, active={active_n})")
        # No refill here: a scale-up means the fleet is under pressure,
        # and the refill boot would compete with it — the scale loop
        # refills the pool once the pressure reading comes back calm.

    def _scale_down(self) -> None:
        """Remove one replica from the ring and drain it gracefully in
        the background (the drain can take minutes; the control loop
        must not stall behind it). The ring removal happens HERE, so
        no new placements land on the victim from this point on."""
        with self._hlock:
            candidates = [n for n in self._active
                          if n not in self._admin_draining]
            if len(self._active) <= self._min or not candidates:
                return
            victim = self._policy.choose_victim(candidates)
            self._admin_draining.add(victim)
            self.health[victim].force_dead(now=time.time())
            self.ring.remove(victim)
            self._active.discard(victim)
            active_n = len(self._active)
        threading.Thread(target=self._demote, args=(victim, active_n),
                         name="g2v-router-demote", daemon=True).start()

    def _demote(self, victim: str, active_n: int) -> None:
        """Graceful scale-down, off the control loop: drain → fence →
        relaunch. The fresh daemon re-queues its own journal OUT of
        the ring and finishes those jobs (its journal recovery), so
        a scale-down never loses work — then the replica parks in the
        warm pool, first in line for the next scale-up."""
        rc = None
        try:
            with self._rep_locks[victim]:
                try:
                    self._request(victim,
                                  {"op": "drain",
                                   "router_epoch": self.router_epoch},
                                  timeout=10.0)
                except (OSError, protocol.ProtocolError):
                    pass
                rc = self.fleet.fence(victim, grace_s=120.0)
                self.metrics.emit("replica_drained", replica=victim,
                                  rc=rc)
                if self._stop.is_set():
                    return
                try:
                    self.fleet.launch(victim)
                except (RuntimeError, TimeoutError, OSError) as e:
                    self.metrics.emit("replica_relaunch_failed",
                                      replica=victim,
                                      error=str(e)[:200])
                    return
        finally:
            with self._hlock:
                self._admin_draining.discard(victim)
        with self._hlock:
            self._warm.append(victim)
            self.scale_downs += 1
            ev = {"kind": "scale_down", "replica": victim, "rc": rc,
                  "active": active_n, "at": round(time.time(), 3)}
            self._last_scale = ev
            self._scale_events.append(ev)
        self.metrics.emit("scale_down", replica=victim,
                          active=active_n, rc=rc)
        self.metrics.emit("warm_spare", replica=victim,
                          outcome="demoted")
        self.console(f"[router] scale-down: -{victim} (drained, "
                     f"rc={rc}, active={active_n})")
        # The drain relaunched the daemon, so the parked spare is a
        # fresh (cold) process — re-warm it for the next promotion.
        self._warm_up(victim)

    def _warm_deficit(self) -> bool:
        """Does the warm pool need another spare? A stale True only
        overfills the pool by one (promotions drain it first — the
        documented, harmless direction)."""
        with self._hlock:
            return len(self._warm) < self.opts.warm_spares

    def _add_warm(self, name: str) -> None:
        with self._hlock:
            self._pending_cold.discard(name)
            self._warm.append(name)

    def _warmup_req(self, name: str, job: dict) -> dict:
        """The canary submit for one spare. ``idem_key`` (the protocol
        field — see protocol.SUBMIT_KEYS) is boot-scoped: stable within
        one daemon boot, so a re-warm of an already-warm process dedups
        to an instant re-ack instead of re-running the canary; a fresh
        boot gets a fresh key and warms once."""
        boots = self.fleet.replica(name).boots
        req = {"op": "submit", "job": job, "tenant": "_warmup",
               "idem_key": f"warmup-{name}-b{boots}",
               "router_epoch": self.router_epoch}
        if not req.get("router_epoch"):
            req.pop("router_epoch", None)     # HA off: byte-compat
        if self.opts.auth_token is not None:
            req["auth_token"] = self.opts.auth_token
        return req

    def _warm_up(self, name: str) -> None:
        """Pre-warm a parked spare with the operator's canary job
        (``--warmup-job``), submitted straight to the OUT-of-ring
        spare and run to completion. A freshly launched daemon is
        only *process*-warm: its first real batch still pays the
        first CUDA use, the kernels' load and the parse, and that
        bill comes due exactly when a surge promotes it (the 1-core
        chaos rig measured a promoted-but-cold spare stalling its
        whole queue ~15 s doing this). The canary is an ordinary
        journaled job against the spare's own state dir with a
        boot-scoped idem key — every fresh process warms once, an
        already-warm process dedups to an instant re-ack, and a
        failure only costs warmth, never the pool slot. Spares are
        promotable mid-warmup: the canary is just a queued job."""
        path = self.opts.warmup_job
        if not path:
            return
        t0 = time.monotonic()
        try:
            with open(path) as fh:
                job = json.load(fh)
            req = self._warmup_req(name, job)
            addr = self._replica_addr(name)
            if not addr:
                raise ConnectionError(f"spare {name} has no address")
            sock = protocol.dial(addr, timeout=10.0)
            try:
                sock.settimeout(600.0)
                f = sock.makefile("rwb")
                protocol.write_event(f, req)
                ev = protocol.read_event(f)
                if ev is None or ev.get("event") != "accepted":
                    raise RuntimeError(f"canary not accepted: "
                                       f"{(ev or {}).get('event')!r} "
                                       f"{(ev or {}).get('error', '')}")
                # Drain the stream: the daemon closes it after the
                # terminal event, so EOF == canary finished.
                while protocol.read_event(f) is not None:
                    pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
        except (OSError, ValueError, RuntimeError,
                protocol.ProtocolError) as e:
            self.metrics.emit("warm_spare", replica=name,
                              outcome="warmup_failed",
                              error=str(e)[:200])
            self.console(f"[router] warm-up of {name} failed: {e}")
        else:
            dt = time.monotonic() - t0
            self.metrics.emit("warm_spare", replica=name,
                              outcome="warmed",
                              warmup_s=round(dt, 3))
            self.console(f"[router] spare {name} warmed ({dt:.1f}s)")

    def _ensure_warm(self) -> None:
        """Refill the warm pool in the background while cold names
        remain. Non-blocking: if a refill thread is already running it
        will converge the pool on its own."""
        if self.opts.warm_spares <= 0 or self._stop.is_set():
            return
        if not self._refill_lock.acquire(blocking=False):
            return

        def _refill():
            try:
                while not self._stop.is_set():
                    if not self._warm_deficit():
                        return
                    name = self._next_cold()
                    if name is None:
                        return
                    try:
                        with self._rep_locks[name]:
                            self.fleet.launch(name)
                    except (RuntimeError, TimeoutError, OSError) as e:
                        with self._hlock:
                            self._pending_cold.discard(name)
                        self.metrics.emit("replica_relaunch_failed",
                                          replica=name,
                                          error=str(e)[:200])
                        return
                    self._add_warm(name)
                    self.metrics.emit("warm_spare", replica=name,
                                      outcome="launched")
                    self.console(f"[router] warm spare {name} ready")
                    # Warm INSIDE the refill loop, deliberately: on a
                    # CPU-shared host two concurrent daemon boots slow
                    # each other (and the active set) more than a
                    # sequential boot→warm→boot chain does.
                    self._warm_up(name)
            finally:
                self._refill_lock.release()

        threading.Thread(target=_refill, name="g2v-router-warm",
                         daemon=True).start()

    # ---- ops --------------------------------------------------------------

    def status(self) -> dict:
        """The one-probe fleet view: per-replica health + role
        (active / warm / cold), ring membership, the scale-event
        ledger, and the scale loop's cached admission aggregate
        (queue totals, per-tenant shed/goodput counters) — answering
        "is the fleet healthy" without N replica round-trips."""
        with self._hlock:
            reps = {}
            for name, h in self.health.items():
                spec = self.fleet.replica(name)
                role = ("active" if name in self._active
                        else "warm" if name in self._warm else "cold")
                reps[name] = dict(h.snapshot(), addr=spec.addr,
                                  pid=spec.pid, boots=spec.boots,
                                  role=role,
                                  assigned=sum(
                                      1 for r in self._assigned.values()
                                      if r == name))
            lats = sorted(self._requeue_latencies)
            jobs_routed, failovers = self.jobs_routed, self.failovers
            active = sorted(self._active)
            warm = list(self._warm)
            ring_members = self.ring.members()
            draining = sorted(self._admin_draining)
            last_scale = dict(self._last_scale) \
                if self._last_scale else None
            scale_ups, scale_downs = self.scale_ups, self.scale_downs
            fleet_stats = dict(self._fleet_stats)
            stale_rejects = self.stale_rejects
        p99 = lats[min(len(lats) - 1,
                       int(0.99 * len(lats)))] if lats else None
        if self._lease is not None:
            leader_view = {"enabled": True, "held": self._lease.held,
                           "epoch": self._lease.epoch,
                           "holder": self._lease.holder,
                           "standby": self.opts.standby}
        else:
            leader_view = {"enabled": False}
        return {"event": "status", "role": "router", "pid": os.getpid(),
                "leader": leader_view,
                "stale_rejects": stale_rejects,
                "uptime_s": round(time.time() - self._t0, 1),
                "listen": (f"{self.tcp_addr[0]}:{self.tcp_addr[1]}"
                           if self.tcp_addr else None),
                "fleet_dir": self.opts.fleet_dir,
                "replicas": reps,
                "active": active,
                "ring": ring_members,
                "warm_pool": warm,
                "warm_pool_size": len(warm),
                "admin_draining": draining,
                "autoscale": {"elastic": self._elastic,
                              "min_replicas": self._min,
                              "max_replicas": self._max,
                              "warm_spares": self.opts.warm_spares,
                              "up_queue": self.opts.scale_up_queue,
                              "down_queue": self.opts.scale_down_queue,
                              "up_wait_s": self.opts.scale_up_wait_s,
                              "interval_s": self.opts.scale_interval},
                "last_scale_event": last_scale,
                "scale_ups": scale_ups,
                "scale_downs": scale_downs,
                "fleet": fleet_stats,
                "jobs_routed": jobs_routed,
                "failovers": failovers,
                "requeue_latency_p99_s": (round(p99, 4)
                                          if p99 is not None else None),
                "requeue_latencies_s": [round(v, 4) for v in lats]}

    def _read_result_any(self, job_id: str) -> Optional[dict]:
        """The durable result record from ANY replica's results dir —
        the fleet is co-located with the router, so the read path skips
        the network (and works while a replica is down)."""
        for name in self.fleet.names():
            path = os.path.join(self._dead_paths(name)[1],
                                f"{job_id}.json")
            try:
                with open(path) as fh:
                    return json.load(fh)
            except (OSError, ValueError):
                continue
        return None

    def _journaled_anywhere(self, job_id: str) -> bool:
        return self._journal_owner(job_id) is not None

    def _journal_owner(self, job_id: str) -> Optional[str]:
        """The replica whose journal holds ``job_id``, or None. Three
        stat calls — cheap enough to consult on every keyed submit."""
        for n in self.fleet.names():
            if os.path.exists(os.path.join(self._dead_paths(n)[0],
                                           f"{job_id}.json")):
                return n
        return None

    def handle_result(self, job_id: str) -> dict:
        rec = self._read_result_any(job_id)
        if rec is not None:
            with self._hlock:
                self._assigned.pop(job_id, None)
            return rec
        return {"event": "pending", "job_id": job_id,
                "journaled": self._journaled_anywhere(job_id)}

    def handle_cancel(self, job_id: str) -> dict:
        """Broadcast: after a failover the client's idea of where the
        job lives is stale, so ask every reachable replica."""
        answers = []
        for name in self.fleet.names():
            try:
                resp = self._request(
                    name, {"op": "cancel", "job_id": job_id,
                           "router_epoch": self.router_epoch},
                    timeout=5.0)
            except (OSError, protocol.ProtocolError):
                continue
            answers.append(dict(resp, replica=name))
            if resp.get("event") in ("cancelled", "cancelling"):
                return dict(resp, replica=name)
        return {"event": "error", "error": f"job {job_id!r} not found on "
                                           f"any reachable replica",
                "answers": answers}

    def handle_drain_replica(self, name: str) -> dict:
        """Synchronous graceful drain of one replica: forward ``drain``,
        wait for the process to exit 0, relaunch it. The journal entries
        it checkpoints re-queue on its OWN relaunch (no migration — this
        is maintenance, not failure). The _admin_draining flag keeps the
        probe loop away for the duration (a half-drained replica answers
        some probes and fails others, which would otherwise declare it
        dead and fire a concurrent, journal-migrating failover), and the
        per-replica lock waits out any failover already in flight before
        touching the process."""
        if name not in self.health:
            return {"event": "error",
                    "error": f"unknown replica {name!r}"}
        with self._hlock:
            if name not in self._active:
                # Warm spares hold zero jobs and cold names hold no
                # process — "draining" either is at best a no-op and at
                # worst a fence/relaunch on a spec the scale controller
                # owns.
                role = "warm" if name in self._warm else "cold"
                return {"event": "error",
                        "error": f"replica {name!r} is not active "
                                 f"(role: {role}); only in-ring "
                                 f"replicas can be drained"}
            if name in self._admin_draining:
                return {"event": "error",
                        "error": f"replica {name!r} is already draining"}
            self._admin_draining.add(name)
            # Out of the ring immediately — no new placements land here.
            self.health[name].force_dead(now=time.time())
        try:
            with self._rep_locks[name]:
                try:
                    resp = self._request(
                        name, {"op": "drain",
                               "router_epoch": self.router_epoch},
                        timeout=10.0)
                except (OSError, protocol.ProtocolError) as e:
                    resp = {"event": "error", "error": str(e)[:200]}
                rc = self.fleet.fence(name, grace_s=120.0)  # graceful
                self.metrics.emit("replica_drained", replica=name, rc=rc)
                try:
                    self.fleet.launch(name)
                except (RuntimeError, TimeoutError, OSError) as e:
                    return {"event": "drained", "replica": name,
                            "rc": rc,
                            "relaunch_error": str(e)[:200],
                            "drain_response": resp}
                return {"event": "drained", "replica": name, "rc": rc,
                        "drain_response": resp}
        finally:
            with self._hlock:
                self._admin_draining.discard(name)

    # ---- query plane ------------------------------------------------------

    def _bundle_owner(self, job_id: str) -> Optional[str]:
        """The replica whose inventory holds a bundle for ``job_id``,
        or None. A disk scan — the same co-located-state trick as
        _journal_owner, so it works whether the owner is alive or not.
        The scan runs at most once per job_id: positive results are
        cached forever (see _owner_cache), which keeps the per-query
        hot path to a dict hit instead of O(replicas) directory walks;
        not-found stays a fresh scan so a bundle published after a
        miss is picked up."""
        owner = self._owner_cache.get(job_id)
        if owner is not None:
            return owner
        for name in self.fleet.names():
            known = inventory.scan_bundles(self._inv_local[name].roots)
            if job_id in known or any(k.startswith(job_id + "/")
                                      for k in known):
                return self._owner_cache.setdefault(job_id, name)
        return None

    def handle_query(self, qreq: dict) -> dict:
        """Route a read to the bundle's home replica (whose mmap + query
        caches are warm for it); answer locally from the shared state
        dirs when that replica is dead — reads survive failover like
        writes do. ``list`` fans out over alive replicas and merges in
        a disk scan of the dead ones'."""
        q = qreq.get("q")
        t0 = time.time()
        if q == "list":
            merged: Dict[str, dict] = {}
            for name in self.fleet.names():
                if not self.fleet.alive(name):
                    continue
                try:
                    resp = self._request(
                        name, {"op": "query", "q": "list"}, timeout=5.0)
                except (OSError, protocol.ProtocolError):
                    continue
                for ent in resp.get("bundles") or []:
                    if isinstance(ent, dict) and ent.get("bundle"):
                        merged.setdefault(ent["bundle"],
                                          dict(ent, replica=name))
            for name in self.fleet.names():
                if self.fleet.alive(name):
                    continue
                for ent in self._inv_local[name].listing():
                    merged.setdefault(ent["bundle"],
                                      dict(ent, replica=name,
                                           replica_down=True))
            self.metrics.emit("query", q="list", cache="none",
                              ms=round((time.time() - t0) * 1e3, 3))
            return {"event": "query_result", "q": "list",
                    "bundles": [merged[k] for k in sorted(merged)]}
        job_id = qreq.get("job_id")
        if not isinstance(job_id, str) or not job_id:
            return {"event": "error", "error": "bad_query",
                    "detail": "query needs a 'job_id' string"}
        owner = self._bundle_owner(job_id)
        if owner is None:
            return {"event": "error", "error": "not_found",
                    "job_id": job_id,
                    "detail": f"no bundle for job {job_id!r} on any "
                              f"replica"}
        if self.fleet.alive(owner):
            try:
                resp = self._request(owner, dict(qreq), timeout=10.0)
                self.metrics.emit(
                    "query", q=q, cache="forwarded", served_by=owner,
                    ms=round((time.time() - t0) * 1e3, 3))
                return dict(resp, replica=owner)
            except (OSError, protocol.ProtocolError):
                # Fall through to the local read; let the probe loop
                # confirm the death on its own cadence.
                with self._hlock:
                    self.health[owner].force_dead(now=time.time())
        cat = self._inv_local[owner]
        key, err = inventory.resolve_bundle_key(
            inventory.scan_bundles(cat.roots), job_id,
            qreq.get("variant"))
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
        try:
            resp = inventory.run_query(cat, q, key, gene=gene, k=k,
                                       mode=mode, nprobe=nprobe)
        except inventory.InventoryError as e:
            self.metrics.emit("query", q=q, cache="router_local",
                              served_by="router", error=e.code,
                              ms=round((time.time() - t0) * 1e3, 3))
            return {"event": "error", "error": e.code,
                    "detail": e.detail, "job_id": job_id, "bundle": key}
        self.metrics.emit("query", q=q, cache="router_local",
                          served_by="router",
                          ms=round((time.time() - t0) * 1e3, 3))
        return dict(resp, event="query_result", served_by="router")

    def handle_fquery(self, fqreq: dict) -> dict:
        """Federated cross-bundle read: scatter the sub-op to every
        ALIVE replica (each answers over its own bundles via
        daemon.handle_fquery), answer DEAD replicas' bundles from their
        shared state dirs exactly like ``list`` does, and merge the
        partials into one ranked list. Every partial carries
        ``served_by`` (and ``replica_down`` for failover reads), and
        ``bundle_overlap`` partials carry ``recall_mode`` — so a caller
        can see per bundle whether the answer came from a live owner or
        a disk read, approximately or exactly."""
        t0 = time.time()
        fq = fqreq.get("fq")
        if fq not in inventory.FQUERY_SUBOPS:
            return {"event": "error", "error": "bad_query",
                    "detail": f"unknown fquery sub-op {fq!r}; expected "
                              f"one of {inventory.FQUERY_SUBOPS}"}
        gene = fqreq.get("gene")
        if not isinstance(gene, str) or not gene:
            return {"event": "error", "error": "bad_query",
                    "detail": "fquery needs a 'gene' string"}
        k = fqreq.get("k", 50)
        if not isinstance(k, int) or isinstance(k, bool):
            return {"event": "error", "error": "bad_query",
                    "detail": f"'k' must be an int, got {k!r}"}
        mode = fqreq.get("mode", "approx")
        if mode not in inventory.QUERY_MODES:
            return {"event": "error", "error": "bad_query",
                    "detail": f"'mode' must be one of "
                              f"{inventory.QUERY_MODES}, got {mode!r}"}
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
            # Resolve the reference neighbor set ONCE through the
            # normal routed read (home replica if alive, shared disk if
            # not), then forward it verbatim to every replica — all
            # partials must score against the same reference.
            job_id = fqreq.get("job_id")
            if not isinstance(job_id, str) or not job_id:
                return {"event": "error", "error": "bad_query",
                        "detail": "bundle_overlap needs 'ref_genes' or "
                                  "a reference 'job_id'"}
            ref = self.handle_query({
                "op": "query", "q": "neighbors", "job_id": job_id,
                "variant": fqreq.get("variant"), "gene": gene, "k": k,
                "mode": mode, "nprobe": nprobe,
                "auth_token": fqreq.get("auth_token")})
            if ref.get("event") != "query_result":
                return ref
            ref_genes = ref.get("neighbors")
        partials: List[dict] = []
        for name in self.fleet.names():
            forwarded = False
            if self.fleet.alive(name):
                try:
                    resp = self._request(
                        name, dict(fqreq, ref_genes=ref_genes),
                        timeout=10.0)
                    forwarded = True
                    if resp.get("event") == "fquery_result":
                        for part in resp.get("bundles") or []:
                            if isinstance(part, dict):
                                partials.append(dict(part,
                                                     served_by=name))
                except (OSError, protocol.ProtocolError):
                    # Fall through to the shared-disk read; the probe
                    # loop confirms the death on its own cadence.
                    with self._hlock:
                        self.health[name].force_dead(now=time.time())
            if forwarded:
                continue
            try:
                local = inventory.run_fquery(
                    self._inv_local[name], fq, gene, k=k, mode=mode,
                    nprobe=nprobe, ref_genes=ref_genes)
            except inventory.InventoryError:
                continue
            partials.extend(dict(p, served_by="router",
                                 replica_down=True) for p in local)
        merged = inventory.merge_fquery(fq, partials)
        self.metrics.emit(
            "fquery", fq=fq, ms=round((time.time() - t0) * 1e3, 3),
            bundles=len(merged),
            replica_down=sum(1 for p in merged
                             if p.get("replica_down")))
        return {"event": "fquery_result", "fq": fq, "gene": gene,
                "k": k, "mode": mode, "bundles": merged,
                "ref_genes": (ref_genes if fq == "bundle_overlap"
                              else None)}

    # ---- submit relay -----------------------------------------------------

    def _relay_submit(self, f, req: dict) -> None:
        payload = sanitize_client_submit(req)
        if not payload.get("idem_key"):
            # Router-minted key: even a client that never heard of idem
            # keys gets exactly-once failover semantics.
            payload["idem_key"] = f"r-{uuid.uuid4().hex}"
        try:
            self._join_key_str(payload)     # router-side admission check
        except (ValueError, TypeError) as e:
            protocol.write_event(f, {"event": "rejected",
                                     "error": "bad_job",
                                     "detail": str(e)[:500]})
            return
        jid = protocol.idem_job_id(payload["idem_key"])
        # Sticky exactly-once routing: a key this fleet has already seen
        # MUST resolve to its existing home, never to a fresh ring
        # placement. The idem dedup table is per-replica, so routing a
        # retried key to a DIFFERENT replica than the (alive) one that
        # journaled it would run the job twice — the ring answers where
        # a NEW key goes; the journals answer where an old one lives.
        # Rescan-in-a-loop because the home can be mid-migration (its
        # replica dead, the probe loop failing it over): the journal
        # entry moves to a survivor, or the result record appears.
        sticky_deadline = time.monotonic() + self.opts.sticky_deadline_s
        last_beat = time.monotonic()
        while time.monotonic() < sticky_deadline:
            rec = self._read_result_any(jid)
            if rec is not None:
                # Already finished somewhere: ack + stream the durable
                # record, exactly like a daemon-side dedup hit.
                protocol.write_event(f, {"event": "accepted",
                                         "job_id": jid, "deduped": True})
                protocol.write_event(f, rec)
                return
            owner = self._journal_owner(jid)
            if owner is None:
                break                      # fresh key -> ring placement
            if self.fleet.alive(owner) \
                    and self._relay_to(f, owner, payload):
                return
            # Home unreachable (dead or dying): never fall through to a
            # successor while its journal entry exists — wait for the
            # probe loop's fence+migrate to move it, then rescan.
            if time.monotonic() - last_beat > 5.0:
                protocol.write_event(f, {"event": "failover_wait",
                                         "job_id": jid, "stale": owner})
                last_beat = time.monotonic()
            time.sleep(0.25)
        else:
            # Sticky deadline expired with the key's journal entry still
            # on an unrecovered replica (relaunch failing over and over).
            # Ring-placing it now would hand the key to a survivor whose
            # idem table has never seen it — the duplicate run the whole
            # sticky scan exists to prevent. Refuse instead; the same
            # idem_key retried later dedups or resumes wherever the
            # entry finally lands.
            rec = self._read_result_any(jid)
            if rec is not None:
                protocol.write_event(f, {"event": "accepted",
                                         "job_id": jid, "deduped": True})
                protocol.write_event(f, rec)
                return
            owner = self._journal_owner(jid)
            if owner is not None:
                self.metrics.emit("submit_retry_later", job_id=jid,
                                  journal_owner=owner)
                protocol.write_event(
                    f, {"event": "rejected", "error": "retry_later",
                        "job_id": jid,
                        "detail": f"job is journaled on unrecovered "
                                  f"replica {owner}; resubmit with the "
                                  f"same idem_key once the fleet heals"})
                return
        tried: List[str] = []
        for _ in range(max(1, len(self.fleet.names()))):
            # Salted placement (join_spread > 1): a hot join-key flash
            # crowd spreads across a bounded candidate set instead of
            # pinning one replica while a promoted spare idles.
            target = self._pick_salted(
                self._join_key_str(payload),
                eligible=[n for n in self._eligible() if n not in tried])
            if target is None:
                break
            tried.append(target)
            sent = self._relay_to(f, target, payload)
            if sent or (sent is None
                        and self._settle_unacked(f, target, payload, jid)):
                return
        protocol.write_event(
            f, {"event": "rejected", "error": "no_replicas",
                "detail": f"no healthy replica reachable "
                          f"(tried {tried or 'none'})"})

    def _settle_unacked(self, f, target: str, payload: dict,
                        jid: str) -> bool:
        """A submit reached ``target`` but no ack came back, so the job
        may be journaled there (and, on a replica that is alive behind a
        partition, running). Placing it on another replica now could run
        it twice. Hold it on ``target`` (a resend dedups there) until a
        result record or a journal entry says where it lives, or until
        ``target`` can admit nothing any more (verified dead, or fenced
        by this router's failover, which has then migrated its journal).
        Returns False in that last case with no trace of the job, so the
        caller places it elsewhere; True once the client got an answer."""
        spec = self.fleet.replica(target)
        deadline = time.monotonic() + self.opts.sticky_deadline_s
        last_beat = time.monotonic()
        while time.monotonic() < deadline and not self._stop.is_set():
            rec = self._read_result_any(jid)
            if rec is not None:
                protocol.write_event(f, {"event": "accepted",
                                         "job_id": jid, "deduped": True})
                protocol.write_event(f, rec)
                return True
            owner = self._journal_owner(jid)
            if owner is None and (
                    leader.read_fence_marker(spec.state_dir) is not None
                    or (spec.local and not self.fleet.alive(target))):
                return False
            home = owner or target
            if self.fleet.alive(home) \
                    and self._relay_to(f, home, payload):
                return True
            if time.monotonic() - last_beat > 5.0:
                protocol.write_event(f, {"event": "failover_wait",
                                         "job_id": jid, "stale": home})
                last_beat = time.monotonic()
            time.sleep(0.25)
        protocol.write_event(
            f, {"event": "rejected", "error": "retry_later", "job_id": jid,
                "detail": f"replica {target} took the submit without an "
                          f"ack and has not recovered; resubmit with the "
                          f"same idem_key"})
        return True

    def _relay_update(self, f, req: dict) -> None:
        """Sticky-route an ``update`` to the TARGET bundle's home
        replica — the generation pointer must have exactly one writer,
        and that writer must be the replica whose inventory root holds
        the bundle (the daemon republishes in place). A retried key
        whose update is already journaled goes back to its journal
        owner (idem dedup lives there); a finished one streams the
        durable record. No ring fallback: an update has exactly one
        legal destination, and relaying it elsewhere would fork the
        bundle's generation history — if the home is down, the client
        gets a structured ``retry_later`` and the same idem_key dedups
        or runs after failover/relaunch."""
        ureq = sanitize_client_submit(req)
        if not ureq.get("idem_key"):
            # Router-minted key: updates are idempotency-keyed by
            # contract (the daemon rejects keyless ones).
            ureq["idem_key"] = f"r-{uuid.uuid4().hex}"
        target = ureq.get("job_id")
        if not isinstance(target, str) or not target:
            protocol.write_event(
                f, {"event": "rejected", "error": "bad_job",
                    "detail": "update needs a 'job_id' string naming "
                              "the target bundle"})
            return
        jid = protocol.idem_job_id(ureq["idem_key"])
        rec = self._read_result_any(jid)
        if rec is not None:
            protocol.write_event(f, {"event": "accepted",
                                     "job_id": jid, "deduped": True})
            protocol.write_event(f, rec)
            return
        owner = self._journal_owner(jid) or self._bundle_owner(target)
        if owner is None:
            protocol.write_event(
                f, {"event": "rejected", "error": "not_found",
                    "job_id": target,
                    "detail": f"no bundle for job {target!r} on any "
                              f"replica"})
            return
        if not self.fleet.alive(owner) \
                or not self._relay_to(f, owner, ureq, op="update"):
            self.metrics.emit("update_retry_later", job_id=jid,
                              bundle_owner=owner)
            protocol.write_event(
                f, {"event": "rejected", "error": "retry_later",
                    "job_id": jid,
                    "detail": f"bundle home {owner} is unreachable; "
                              f"retry with the same idem_key once the "
                              f"replica relaunches"})
        return

    def _relay_to(self, f, target: str, payload: dict,
                  op: str = "submit") -> Optional[bool]:
        """Forward one submit/update to ``target`` and relay its event
        stream. Returns True once an answer was relayed; False when
        nothing can have been accepted (the dial failed, or the replica
        answered ``fenced``: a quarantined replica admits nothing), so
        the next ring successor is safe; None when the request went out
        but no answer came back: the replica may have journaled it."""
        out = dict(payload, op=op,
                   router_epoch=self.router_epoch)
        if not out.get("router_epoch"):
            out.pop("router_epoch", None)     # HA off: byte-compat
        if self.opts.auth_token is not None:
            out["auth_token"] = self.opts.auth_token
        addr = self._replica_addr(target)
        if not addr:
            return False
        try:
            sock = protocol.dial(addr, timeout=10.0)
        except OSError:
            with self._hlock:
                self.health[target].force_dead(now=time.time())
            return False
        rf = sock.makefile("rwb")
        try:
            try:
                protocol.write_event(rf, out)
                first = protocol.read_event(rf)
            except (OSError, protocol.ProtocolError):
                first = None
            if first is None:
                # No ack: a replica that died before reading the request
                # and one whose ack was lost (an asymmetric partition)
                # look the same from here.
                return None
            if first.get("error") == "fenced":
                return False
            if first.get("error") == "stale_epoch":
                # WE are the zombie: a newer leader exists. Surface the
                # reject to the client rather than spraying the stale
                # submit at ring successors (each would reject it too).
                self._on_stale_epoch(target, op, first)
                protocol.write_event(f, first)
                return True
            job_id = first.get("job_id")
            if first.get("event") == "accepted" and job_id:
                # Relay threads run concurrently: the count and the
                # assignment move together under _hlock.
                with self._hlock:
                    self.jobs_routed += 1
                    self._assigned[job_id] = target
                first = dict(first, replica=target)
                self.metrics.emit("job_routed", job_id=job_id,
                                  replica=target,
                                  deduped=bool(first.get("deduped")))
            protocol.write_event(f, first)
            if first.get("event") != "accepted":
                return True
            sock.settimeout(None)          # a batch can run for minutes
            terminal = False
            while True:
                try:
                    ev = protocol.read_event(rf)
                except (OSError, protocol.ProtocolError):
                    ev = None
                if ev is None:
                    break
                protocol.write_event(f, ev)
                if ev.get("event", "").startswith("job_") \
                        and ev.get("event") != "job_state":
                    terminal = ev.get("event") in (
                        "job_done", "job_failed", "job_cancelled",
                        "job_deadline_exceeded")
            if terminal:
                with self._hlock:
                    self._assigned.pop(job_id, None)
                return True
            # Stream died after the ack with no terminal event — the
            # replica (or its connection) is gone. The job is journaled
            # there; the probe loop will fail it over. Hold the client
            # and poll the durable record instead of dropping them.
            protocol.write_event(f, {"event": "stream_lost",
                                     "job_id": job_id,
                                     "replica": target,
                                     "note": "replica connection lost "
                                             "after ack; awaiting "
                                             "failover result"})
            self._await_result(f, job_id)
            return True
        finally:
            try:
                rf.close()
                sock.close()
            except OSError:
                pass

    def _await_result(self, f, job_id: str) -> None:
        """Poll the fleet's durable records until the failed-over job
        lands, streaming keepalives so a dead client ends the loop."""
        last_beat = time.monotonic()
        while not self._stop.is_set():
            rec = self._read_result_any(job_id)
            if rec is not None:
                protocol.write_event(f, rec)
                with self._hlock:
                    self._assigned.pop(job_id, None)
                return
            if time.monotonic() - last_beat > 5.0:
                # Raises to the caller when the client hung up.
                protocol.write_event(f, {"event": "failover_wait",
                                         "job_id": job_id})
                last_beat = time.monotonic()
            time.sleep(0.2)

    # ---- front-end --------------------------------------------------------

    def _handle_conn(self, conn: socket.socket) -> None:
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
                return
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
            try:
                req = json.loads(first)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                protocol.write_event(f, {"event": "error",
                                         "error": f"bad request: {e}"})
                return
            op = req.get("op")
            if self.opts.auth_token is not None and op in _AUTH_OPS \
                    and req.get("auth_token") != self.opts.auth_token:
                self.metrics.emit("auth_rejected", op=op)
                protocol.write_event(
                    f, {"event": "rejected", "error": "unauthorized",
                        "detail": f"op {op!r} requires a valid "
                                  f"'auth_token' on this listener"})
                return
            if op == "submit":
                self._relay_submit(f, req)
            elif op == "update":
                self._relay_update(f, req)
            elif op == "status":
                protocol.write_event(f, self.status())
            elif op == "ping":
                protocol.write_event(f, {"event": "pong", "role": "router",
                                         "pid": os.getpid()})
            elif op == "result":
                rreq = req
                job_id = rreq.get("job_id")
                if not isinstance(job_id, str) or not job_id:
                    protocol.write_event(
                        f, {"event": "error",
                            "error": "result needs a 'job_id' string"})
                else:
                    resp = self.handle_result(job_id)
                    if resp.get("event") != "pending":
                        resp = protocol.bound_record(
                            resp, rreq.get("fields"),
                            rreq.get("max_bytes"),
                            self.opts.max_result_bytes
                            or protocol.MAX_LINE_BYTES)
                    protocol.write_event(f, resp)
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
                    protocol.write_event(f, self.handle_cancel(job_id))
            elif op == "drain_replica":
                name = req.get("replica")
                if not isinstance(name, str) or not name:
                    protocol.write_event(
                        f, {"event": "error",
                            "error": "drain_replica needs a 'replica' "
                                     "string"})
                else:
                    protocol.write_event(f,
                                         self.handle_drain_replica(name))
            elif op == "shutdown":
                protocol.write_event(
                    f, {"event": "shutting_down",
                        "note": "replicas get SIGTERM (graceful drain); "
                                "journaled jobs re-queue on next start"})
                self._stop.set()
            else:
                protocol.write_event(f, {"event": "error",
                                         "error": f"unknown op {op!r}"})
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    def _serve_http(self, f, first: bytes) -> None:
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

    # ---- lifecycle --------------------------------------------------------

    def boot_fleet(self) -> None:
        """Launch or adopt the ACTIVE replicas (the fleet is sized for
        the elastic maximum plus warm headroom — which names run is
        decided here and by the scale controller, not by the spec
        count). A dead active replica with a journal gets the full
        failover treatment AFTER the survivors are up, so its jobs
        migrate instead of waiting for its relaunch. Journals stranded
        on names OUTSIDE the active set (a previous run with wider
        bounds) migrate to the survivors without a relaunch. Ends by
        kicking the warm-pool fill."""
        with self._hlock:
            targets = sorted(self._active)
        live, dead = [], []
        for name in targets:
            spec = self.fleet.replica(name)
            addr_file = os.path.join(spec.state_dir, "tcp_addr")
            if os.path.exists(addr_file):
                with open(addr_file) as fh:
                    spec.addr = fh.read().strip()
                ok, jd = self.probe(name)
                if ok:
                    live.append(name)
                    self.metrics.emit("replica_adopted", replica=name,
                                      pid=spec.pid, journal_depth=jd)
                    self.console(f"[router] adopted live replica {name} "
                                 f"(pid {spec.pid})")
                    continue
            dead.append(name)
        for name in dead:
            jobs_dir = self._dead_paths(name)[0]
            depth = len(glob.glob(os.path.join(jobs_dir, "*.json"))) \
                if os.path.isdir(jobs_dir) else 0
            if depth and live:
                # Survivors exist: migrate, then relaunch (inside).
                with self._hlock:
                    self.health[name].force_dead(now=time.time())
                self._failover(name)
            elif not self.opts.remote_replicas:
                # Remote fleets are adopted, never launched: the daemons
                # live on other hosts and a local Popen would just fork
                # a replica nobody asked for.
                try:
                    self.fleet.launch(name)
                except (RuntimeError, TimeoutError, OSError) as e:
                    self.metrics.emit("replica_relaunch_failed",
                                      replica=name, error=str(e)[:200])
                    raise
            live.append(name)
        for name in self.fleet.names():
            if name in targets:
                continue
            jobs_dir = self._dead_paths(name)[0]
            depth = len(glob.glob(os.path.join(jobs_dir, "*.json"))) \
                if os.path.isdir(jobs_dir) else 0
            if depth and live:
                with self._hlock:
                    self.health[name].force_dead(now=time.time())
                self._failover(name, relaunch=False)
        self._ensure_warm()

    def _lease_loop(self) -> None:
        """Renew the leadership lease at ttl/3.  On loss the router
        KEEPS serving — reads stay correct, and every mutating command
        it still emits carries its now-stale epoch, which daemons
        reject (``stale_epoch``).  The loop keeps trying to re-acquire:
        if the usurper dies in turn, this router resumes leadership
        with a fresh, higher epoch."""
        assert self._lease is not None
        interval = max(0.2, self._lease.ttl_s / 3.0)
        while not self._stop.wait(interval):
            if self._lease.held:
                if not self._lease.renew():
                    self.console(
                        f"[router] LOST leadership lease (epoch "
                        f"{self._lease.epoch} superseded) — serving "
                        f"reads only; mutations will be fenced")
            elif self._lease.acquire():
                # Re-elected (the usurper died or released).
                self.metrics.emit("leader_elected",
                                  epoch=self._lease.epoch,
                                  holder=self._lease.holder,
                                  standby=self.opts.standby)
                self.console(f"[router] re-acquired leadership lease "
                             f"(epoch {self._lease.epoch})")

    def serve_forever(self) -> int:
        import signal

        # Same GIL-handoff tuning as the daemon's serve loop: relay
        # threads, the probe loop, and router-local failover reads all
        # share this interpreter, and a forwarded query's wall includes
        # every GIL hold on the relay path.
        sys.setswitchinterval(1e-3)

        def _on_sigterm(*_):
            self._stop.set()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass
        if self._lease is not None:
            # Leadership gates EVERYTHING below: a standby must not
            # boot replicas, bind, or publish router_addr/router.pid
            # until it actually holds the lease — the active router's
            # clients are still reading those files.
            t_wait = time.time()
            if self.opts.standby:
                self.console(f"[router] standby: watching lease in "
                             f"{self.opts.fleet_dir} as "
                             f"{self._lease.holder}")
                if not leader.wait_for_leadership(
                        self._lease, stop=self._stop):
                    self.console("[router] standby stopped before "
                                 "taking over")
                    self.metrics.close()
                    return 0
                takeover_s = round(time.time() - t_wait, 3)
                self.metrics.emit("leader_elected",
                                  epoch=self._lease.epoch,
                                  holder=self._lease.holder,
                                  standby=True, takeover_s=takeover_s)
                self.console(f"[router] standby took over: epoch "
                             f"{self._lease.epoch} after {takeover_s}s")
            else:
                if not self._lease.acquire():
                    st, _ = self._lease.peek()
                    self.console(
                        f"[router] lease in {self.opts.fleet_dir} is "
                        f"held by "
                        f"{st.holder if st else 'unknown'} — start "
                        f"with --standby to wait for it")
                    self.metrics.close()
                    return 1
                self.metrics.emit("leader_elected",
                                  epoch=self._lease.epoch,
                                  holder=self._lease.holder,
                                  standby=False)
            renewer = threading.Thread(target=self._lease_loop,
                                       name="g2v-router-lease",
                                       daemon=True)
            renewer.start()
        try:
            self.boot_fleet()
        except (RuntimeError, TimeoutError, OSError) as e:
            # A replica that cannot boot (no card, say) fails the
            # router's start loudly: no replica is left running behind a
            # router that never bound.
            self.console(f"[router] cannot start: {e}")
            self._stop.set()
            self.fleet.stop_all(grace_s=10.0)
            if self._lease is not None:
                self._lease.release()
            self.metrics.close()
            return 1
        host, port = protocol.parse_addr(self.opts.listen)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        srv.settimeout(0.25)
        self.tcp_addr = srv.getsockname()[:2]
        addr_file = os.path.join(self.opts.fleet_dir, "router_addr")
        with open(addr_file + ".tmp", "w") as fh:
            fh.write(f"{self.tcp_addr[0]}:{self.tcp_addr[1]}\n")
        os.replace(addr_file + ".tmp", addr_file)
        with open(os.path.join(self.opts.fleet_dir, "router.pid"),
                  "w") as fh:
            fh.write(str(os.getpid()))
        prober = threading.Thread(target=self._probe_loop,
                                  name="g2v-router-probe", daemon=True)
        prober.start()
        scaler = threading.Thread(target=self._scale_loop,
                                  name="g2v-router-scale", daemon=True)
        scaler.start()
        with self._hlock:
            active_n = len(self._active)
        self.metrics.emit("router_start", pid=os.getpid(),
                          listen=f"{self.tcp_addr[0]}:{self.tcp_addr[1]}",
                          replicas=self.fleet.names())
        self.console(f"[router] fronting {active_n} of "
                     f"{len(self.fleet.names())} replica(s) on "
                     f"{self.tcp_addr[0]}:{self.tcp_addr[1]} "
                     f"(fleet {self.opts.fleet_dir}"
                     f"{', elastic' if self._elastic else ''})")
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=self._handle_conn, args=(conn,),
                                 name="g2v-router-conn",
                                 daemon=True).start()
        finally:
            srv.close()
            prober.join(timeout=5.0)
            scaler.join(timeout=5.0)
            self.fleet.stop_all(grace_s=60.0)
            if self._lease is not None:
                # Clean exit: drop the lease so a standby takes over
                # immediately instead of waiting out the ttl.
                self._lease.release()
            self.metrics.emit("router_stop", jobs_routed=self.jobs_routed,
                              failovers=self.failovers)
            self.metrics.close()
            self.console(f"[router] stopped ({self.jobs_routed} job(s) "
                         f"routed, {self.failovers} failover(s))")
        return 0
