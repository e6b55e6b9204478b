"""Cooperative job interruption — the exception vocabulary of the
durable-job layer (serve/daemon.py + batch/engine.py + both trainers).

The port's copy of ``g2vec_tpu/resilience/lifecycle.py``: the
interruptions and the admission SLOs (:class:`TokenBucket`,
:func:`shed_decision`). The router's replica health and scaling policy
come with the multi-replica half of serve (not ported yet).

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
# Admission SLOs — per-tenant rate limiting and deadline-aware shedding.
# ---------------------------------------------------------------------------


class TokenBucket:
    """Classic token-bucket rate limiter, pure:
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
