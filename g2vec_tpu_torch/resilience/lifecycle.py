"""Cooperative job interruption — the exception vocabulary of the
durable-job layer (serve/daemon.py + batch/engine.py + both trainers).

The port's copy of ``g2vec_tpu/resilience/lifecycle.py``: the
interruptions, the router's replica health machine
(:class:`ReplicaHealth`), the admission SLOs (:class:`TokenBucket`,
:func:`shed_decision`) and the router's scaling policy
(:class:`ScalingPolicy`). Nothing here imports torch.

The daemon threads a zero-argument ``check`` callable through
``ResidentEngine.execute`` into the trainers' epoch/shard loops. The
trainers call it at every consistent boundary (full-batch: top of each
chunk; streaming: every shard step, where the cursor checkpoint is also
cut). When the daemon wants a job stopped — client cancel, deadline
passed, SIGTERM drain — ``check`` raises one of these, the trainer
unwinds (the streaming trainer checkpoints its cursor first on a drain),
and the daemon maps the exception back to a per-job terminal or
re-queued state. Cooperative beats preemptive here: the boundaries are
exactly where device state is host-consistent, so an interrupted job is
always either resumable or cleanly terminal, never torn.
"""
from __future__ import annotations

import random


class JobInterrupted(RuntimeError):
    """Base of all cooperative interruptions. ``job_id`` is the serve job
    the interruption targets (None for whole-process reasons like drain —
    every job in the batch is affected)."""

    reason = "interrupted"

    def __init__(self, job_id=None, detail: str = ""):
        self.job_id = job_id
        msg = f"job {job_id}: {self.reason}" if job_id else self.reason
        super().__init__(f"{msg} ({detail})" if detail else msg)


class JobCancelled(JobInterrupted):
    """A client asked for this specific job to stop. Terminal."""

    reason = "cancelled"


class JobDeadlineExceeded(JobInterrupted):
    """The job's ``deadline_s`` elapsed before it finished. Terminal."""

    reason = "deadline_exceeded"


class DrainRequested(JobInterrupted):
    """The daemon is draining (SIGTERM). NOT terminal for the job: the
    streaming trainer checkpoints its cursor before re-raising, the
    daemon leaves the job journaled, and the next daemon run resumes
    it from the checkpoint."""

    reason = "drain"


# ---------------------------------------------------------------------------
# Replica health — the router's per-replica probe state machine.
# ---------------------------------------------------------------------------

#: healthy → suspect → dead → rejoining → healthy. ``suspect`` keeps the
#: replica in the hash ring (a single missed probe is usually GC or a
#: long compile, not death); ``dead`` removes it and triggers failover;
#: ``rejoining`` answers probes again but takes no traffic until its
#: stale journal is drained.
REPLICA_STATES = ("healthy", "suspect", "dead", "rejoining")


class ReplicaHealth:
    """Pure probe-driven health state for one replica. No I/O, no clock
    reads — the router feeds it ``on_probe(ok, journal_depth, now)`` and
    acts on the returned transition, which keeps every edge unit-testable
    as a table.

    Thresholds: ``suspect_after`` consecutive failures demote healthy →
    suspect, ``dead_after`` total consecutive failures declare dead (the
    failover trigger — the router fences the process before re-queueing,
    so a slow-but-alive replica can never double-execute), and a dead
    replica that answers again must produce ``rejoin_after`` consecutive
    OK probes **with an empty journal** before it is healthy: the empty-
    journal gate is what forces a rejoining replica to drain stale work
    (or have the router migrate it) before taking new traffic.

    ``probe_interval(base)`` backs off exponentially for non-healthy
    replicas so a dead host costs probes, not a probe *storm*.
    """

    def __init__(self, name: str, suspect_after: int = 1,
                 dead_after: int = 3, rejoin_after: int = 2):
        if not (1 <= suspect_after < dead_after):
            raise ValueError("need 1 <= suspect_after < dead_after")
        self.name = name
        self.state = "healthy"
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.rejoin_after = rejoin_after
        self.fails = 0          # consecutive failed probes
        self.oks = 0            # consecutive OK probes (rejoin gate)
        self.last_ok: float = 0.0
        self.last_transition: float = 0.0
        self.journal_depth: int = 0

    @property
    def in_ring(self) -> bool:
        """Whether the hash ring may route new jobs here."""
        return self.state in ("healthy", "suspect")

    def probe_interval(self, base: float) -> float:
        """Seconds until the next probe: ``base`` while healthy, doubled
        per consecutive failure (capped at 8x) otherwise — plus nothing;
        jitter is the caller's business."""
        if self.state == "healthy":
            return base
        return base * min(8.0, 2.0 ** max(0, self.fails - 1))

    def on_probe(self, ok: bool, journal_depth: int = 0,
                 now: float = 0.0):
        """Feed one probe outcome. Returns ``(old_state, new_state)`` on
        a transition, else None."""
        old = self.state
        if ok:
            self.fails = 0
            self.oks += 1
            self.last_ok = now
            self.journal_depth = journal_depth
            if old in ("healthy", "suspect"):
                self.state = "healthy"
            elif old == "dead":
                self.state = "rejoining"
                self.oks = 1        # this probe is the first of the gate
            elif old == "rejoining":
                if self.oks >= self.rejoin_after and journal_depth == 0:
                    self.state = "healthy"
        else:
            self.fails += 1
            self.oks = 0
            if old == "rejoining":
                self.state = "dead"     # flapped straight back out
            elif old in ("healthy", "suspect"):
                if self.fails >= self.dead_after:
                    self.state = "dead"
                elif self.fails >= self.suspect_after:
                    self.state = "suspect"
        if self.state != old:
            self.last_transition = now
            return (old, self.state)
        return None

    def force_dead(self, now: float = 0.0):
        """The router *observed* death out-of-band (connection refused on
        a forward, fence kill). Skips the probe count."""
        old = self.state
        self.state = "dead"
        self.fails = max(self.fails, self.dead_after)
        self.oks = 0
        if old != "dead":
            self.last_transition = now
            return (old, "dead")
        return None

    def snapshot(self) -> dict:
        return {"name": self.name, "state": self.state,
                "fails": self.fails, "oks": self.oks,
                "journal_depth": self.journal_depth,
                "last_ok": self.last_ok}


# ---------------------------------------------------------------------------
# Admission SLOs — per-tenant rate limiting and deadline-aware shedding.
# ---------------------------------------------------------------------------


class TokenBucket:
    """Classic token-bucket rate limiter, pure like :class:`ReplicaHealth`:
    the caller supplies ``now`` on every call, so refill math is exact
    and every edge (burst boundary, fractional refill, idle catch-up) is
    unit-testable without sleeping.

    ``rate`` tokens/second refill up to ``burst`` capacity; ``take``
    consumes one if available. ``retry_after`` answers the *useful*
    refusal: not "no", but "no for this many more seconds" — the number
    the daemon's structured ``tenant_quota`` rejection carries so a
    well-behaved client backs off exactly long enough."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket needs rate > 0 and burst > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)      # full at birth: allow the burst
        self._last: float = 0.0         # now of the last refill
        self._primed = False

    def _refill(self, now: float):
        if not self._primed:
            self._primed = True
            self._last = now
            return
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now

    def take(self, now: float, n: float = 1.0) -> bool:
        """Consume ``n`` tokens if available. False = rate-limited."""
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, now: float, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will exist (0.0 = already there)."""
        self._refill(now)
        if self.tokens >= n:
            return 0.0
        return (n - self.tokens) / self.rate

    def snapshot(self) -> dict:
        return {"rate": self.rate, "burst": self.burst,
                "tokens": round(self.tokens, 6)}


def shed_decision(deadline_s, queued: int, service_time_s):
    """Deadline-aware admission check. Returns ``None`` to admit, or a
    positive ``retry_after_s`` (seconds) to shed.

    The estimate is deliberately simple — ``queued × observed per-job
    service time`` — because it only has to be *directionally* right:
    accepting a job whose estimated wait already exceeds its whole
    ``deadline_s`` burns a queue slot, walk sampling, and training time
    on work that is contractually dead on arrival. Boundary semantics
    (pinned by tests):

    - no deadline (``None``) → never shed; the job can wait forever,
    - no service-time observation yet (``None``) → never shed; without
      evidence the conservative call is to accept,
    - estimated wait exactly equal to the deadline → admit (shed only
      on strict excess),
    - ``retry_after_s`` = the excess wait, floored at one service time,
      i.e. how long the queue needs to drain before this job could
      plausibly make its deadline."""
    if deadline_s is None or service_time_s is None:
        return None
    est_wait = max(0, queued) * float(service_time_s)
    if est_wait <= float(deadline_s):
        return None
    return max(float(service_time_s), est_wait - float(deadline_s))


# ---------------------------------------------------------------------------
# Scaling policy — the router's hysteretic replica-count controller.
# ---------------------------------------------------------------------------


class ScalingPolicy:
    """Seeded, hysteretic scale controller. Pure: the router feeds it one
    ``observe(queued_total, active, est_wait_s)`` per control tick and
    acts on the returned decision (``"up"`` / ``"down"`` / ``"hold"``).

    Two signals, asymmetric thresholds, streak counting, and a cooldown
    — the classic recipe against flapping:

    - **pressure** = queued jobs per active replica. ``up_queue`` and
      ``down_queue`` are deliberately far apart (default 4.0 vs 0.5) so
      the region between them is a dead band.
    - **wait** — the fleet-MEAN queue-drain estimate (total queued ×
      mean observed service time / reachable replicas), not a tail
      percentile: tune ``up_wait_s`` as "a typical queued job waits
      this long", not as a p99. Scale-up also triggers when it crosses
      ``up_wait_s`` even at modest depth (a few slow jobs hurt
      deadlines as much as many fast ones).
    - A decision needs ``up_ticks`` (or ``down_ticks``) *consecutive*
      ticks beyond threshold; any tick back inside the band resets the
      streak, so a square-wave load (spike, quiet, spike …) that flips
      faster than the streak length produces zero decisions.
    - After any decision, ``cooldown_ticks`` ticks of enforced hold let
      the fleet absorb the change before the next one.

    Scale-down is much slower than scale-up (6 ticks vs 2 by default):
    adding capacity late costs deadlines, removing it late costs only a
    warm idle process. ``choose_victim`` picks the replica to drain with
    the policy's own seeded rng, so a chaos run with a fixed seed drains
    the same replicas every time."""

    def __init__(self, min_replicas: int, max_replicas: int,
                 up_queue: float = 4.0, down_queue: float = 0.5,
                 up_wait_s: float = 8.0, up_ticks: int = 2,
                 down_ticks: int = 6, cooldown_ticks: int = 5,
                 seed: int = 0):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if not (0 <= down_queue < up_queue):
            raise ValueError("need 0 <= down_queue < up_queue")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_queue = float(up_queue)
        self.down_queue = float(down_queue)
        self.up_wait_s = float(up_wait_s)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_ticks = int(cooldown_ticks)
        self.rng = random.Random(seed)
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown = 0
        self.ticks = 0
        self.decisions = 0

    def observe(self, queued_total: int, active: int,
                est_wait_s=None) -> str:
        """Feed one control tick; returns ``"up"``, ``"down"`` or
        ``"hold"``. The caller is responsible for actually changing the
        fleet — the policy only counts and decides."""
        self.ticks += 1
        pressure = queued_total / max(1, active)
        hot = (pressure >= self.up_queue
               or (est_wait_s is not None
                   and est_wait_s >= self.up_wait_s))
        cold = (pressure <= self.down_queue
                and (est_wait_s is None or est_wait_s < self.up_wait_s))
        if hot:
            self.up_streak += 1
            self.down_streak = 0
        elif cold:
            self.down_streak += 1
            self.up_streak = 0
        else:                   # dead band — reset both streaks
            self.up_streak = 0
            self.down_streak = 0
        if self.cooldown > 0:
            self.cooldown -= 1
            return "hold"
        if (self.up_streak >= self.up_ticks
                and active < self.max_replicas):
            self.up_streak = 0
            self.cooldown = self.cooldown_ticks
            self.decisions += 1
            return "up"
        if (self.down_streak >= self.down_ticks
                and active > self.min_replicas):
            self.down_streak = 0
            self.cooldown = self.cooldown_ticks
            self.decisions += 1
            return "down"
        return "hold"

    def choose_victim(self, candidates):
        """Seeded pick of the replica to drain on scale-down. Sorted
        input + the policy's own rng = reproducible under a fixed seed."""
        ordered = sorted(candidates)
        if not ordered:
            return None
        return self.rng.choice(ordered)

    def snapshot(self) -> dict:
        return {"min": self.min_replicas, "max": self.max_replicas,
                "up_streak": self.up_streak,
                "down_streak": self.down_streak,
                "cooldown": self.cooldown, "ticks": self.ticks,
                "decisions": self.decisions}
