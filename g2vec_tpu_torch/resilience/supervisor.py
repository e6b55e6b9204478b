"""Auto-resume supervision: bounded retries around ``pipeline.run``.

The port's copy of ``g2vec_tpu/resilience/supervisor.py``, one process
(the router's ``ReplicaFleet`` comes with the multi-replica half of
serve). Three entry points with one retry policy:

- :func:`supervise`, in process: call ``pipeline.run(cfg)``, classify any
  exception, and re-enter with ``resume=True`` after exponential backoff
  with jitter.
- :func:`supervise_cli`, the ``--supervise`` CLI path: re-run ``python -m
  g2vec_tpu_torch`` with the original argv (without the supervisor's
  flags, with ``--resume``) and classify the child's exit. This is the
  only mode that survives a SIGKILL, and it holds no CUDA context: this
  module imports no torch.
- :func:`supervise_serve`, the ``serve --supervise`` watchdog: relaunch
  ``python -m g2vec_tpu_torch serve`` until it exits 0; the daemon's
  journal re-queues its unfinished jobs on every start.

Classification, as the JAX package's:

retryable: ``InjectedFault``, ``RuntimeError`` (``torch.cuda.
OutOfMemoryError`` among them), ``MemoryError``, ``ConnectionError``,
``OSError``; in child mode any exit by a signal.

fatal: ``InjectedFatal``, ``ValueError`` (config and reader validation;
unless its message matches a retryable pattern such as "out of memory"),
``TypeError``, ``KeyError``, ``AttributeError``, ``ImportError``,
``NotImplementedError``, ``FileNotFoundError``, ``PermissionError``,
``IsADirectoryError``.

One difference, a fact of the card the JAX package does not face: a CUDA
launch error or illegal memory access is sticky. The process's CUDA
context stays broken, so an in-process retry would fail the same way.
:func:`supervise` classifies a ``RuntimeError`` whose message names a
CUDA error (``CUDA error``, ``cudaError``, ``illegal memory access``)
fatal and says to run with ``--supervise``; the child mode retries it in
a fresh process.

Every decision is appended to the run's ``--metrics-jsonl`` stream
(``retry``, ``resume``, ``gave_up``, ``supervised_done``).
"""
from __future__ import annotations

import dataclasses
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

from g2vec_tpu_torch.resilience.faults import (ENV_PLAN, ENV_STATE,
                                               InjectedFatal, InjectedFault)

# Message patterns that mark an otherwise fatal-typed exception as
# preemption- or capacity-shaped.
RETRYABLE_MESSAGE = re.compile(
    r"preempt|out of memory|resource[ _]?exhausted|oom\b|unavailable|"
    r"deadline|collective|all[- ]reduce|socket closed|connection reset|"
    r"data[ _]?loss|injected (crash|stall)|PeerTimeoutError", re.I)

#: A CUDA error that leaves the process's context broken.
CUDA_STICKY_MESSAGE = re.compile(
    r"CUDA error|cudaError|illegal memory access")

_FATAL_TYPES = (InjectedFatal, FileNotFoundError, IsADirectoryError,
                PermissionError, TypeError, KeyError, AttributeError,
                ImportError, NotImplementedError)
_RETRYABLE_TYPES = (InjectedFault, MemoryError, ConnectionError)

# Child-mode stderr classification: the last traceback line names the type.
_FATAL_NAME = re.compile(
    r"\b(InjectedFatal|ValueError|TypeError|KeyError|AttributeError|"
    r"ImportError|ModuleNotFoundError|NotImplementedError|"
    r"FileNotFoundError|PermissionError|IsADirectoryError)\b")


def _out_of_memory(exc: BaseException) -> bool:
    """``torch.cuda.OutOfMemoryError``, or a message that says so (without
    importing torch: a process that never did cannot have raised it)."""
    torch = sys.modules.get("torch")
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return (oom is not None and isinstance(exc, oom)) or \
        "out of memory" in str(exc).lower()


def _cuda_sticky(exc: BaseException) -> bool:
    """A CUDA error that leaves the context broken (an out-of-memory does
    not: the allocation failed, the context stands)."""
    return (isinstance(exc, RuntimeError)
            and not isinstance(exc, InjectedFault)
            and not _out_of_memory(exc)
            and bool(CUDA_STICKY_MESSAGE.search(str(exc))))


def classify_exception(exc: BaseException) -> str:
    """Return ``"retryable"`` or ``"fatal"`` for an in-process failure."""
    from g2vec_tpu_torch.resilience.lifecycle import JobInterrupted

    if isinstance(exc, JobInterrupted):
        # A cooperative interruption is an answer, not a failure: it never
        # enters a retry loop (the daemon handles it before classifying;
        # this guard is for any other caller).
        return "fatal"
    if isinstance(exc, _RETRYABLE_TYPES):
        return "retryable"
    if isinstance(exc, InjectedFatal):
        return "fatal"
    if isinstance(exc, ValueError):
        # Reader/config validation errors are ValueError by contract, but
        # a capacity error may be one too: the message gets a vote.
        return "retryable" if RETRYABLE_MESSAGE.search(str(exc)) else "fatal"
    if isinstance(exc, _FATAL_TYPES):
        return "fatal"
    if _cuda_sticky(exc):
        return "fatal"          # in process; --supervise retries it
    # RuntimeError (an out-of-memory on the card included), OSError and
    # anything unknown: assume worker-death shape. The bounded retry
    # budget caps the cost of guessing wrong.
    return "retryable"


def classify_child(returncode: int, stderr_tail: str) -> str:
    """Classify a supervised child process's exit (``supervise_cli``). A
    CUDA error is retryable here: the retry is a fresh process."""
    if returncode < 0:
        return "retryable"     # killed by a signal: preemption-shaped
    if RETRYABLE_MESSAGE.search(stderr_tail):
        return "retryable"
    if "InjectedFault" in stderr_tail:
        return "retryable"
    if _FATAL_NAME.search(stderr_tail):
        return "fatal"
    return "retryable"


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3        # retries, not attempts: N+1 runs total
    backoff_base: float = 1.0   # seconds; doubles per retry
    backoff_max: float = 60.0
    jitter: float = 0.25        # +[0, jitter) fraction

    def delay(self, attempt: int, rng: random.Random) -> float:
        base = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        return base * (1.0 + self.jitter * rng.random())


def _policy_from_cfg(cfg) -> RetryPolicy:
    return RetryPolicy(max_retries=cfg.supervise_retries,
                       backoff_base=cfg.supervise_backoff)


def _event_writer(cfg):
    from g2vec_tpu_torch.utils.metrics import MetricsWriter

    return MetricsWriter(cfg.metrics_jsonl, append=True)


def supervise(cfg, policy: Optional[RetryPolicy] = None,
              console: Callable[[str], None] = print,
              sleep: Callable[[float], None] = time.sleep):
    """Run the pipeline under in-process supervision; returns its
    PipelineResult or re-raises the exception that ended the policy."""
    from g2vec_tpu_torch.pipeline import run

    policy = policy if policy is not None else _policy_from_cfg(cfg)
    rng = random.Random(cfg.seed)
    attempt = 0
    while True:
        try:
            result = run(cfg, console=console)
        except BaseException as e:  # noqa: BLE001 — classified right below
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            verdict = classify_exception(e)
            err = f"{type(e).__name__}: {e}"[:500]
            if _cuda_sticky(e):
                err = (err[:380] + " [a CUDA error leaves this process's "
                       "context broken: run with --supervise to retry in "
                       "a fresh process]")
            if verdict == "fatal" or attempt >= policy.max_retries:
                with _event_writer(cfg) as events:
                    events.emit("gave_up", attempt=attempt, classified=verdict,
                                error=err)
                console(f"[supervisor] giving up after attempt {attempt}: "
                        f"{verdict} — {err}")
                raise
            delay = policy.delay(attempt, rng)
            with _event_writer(cfg) as events:
                events.emit("retry", attempt=attempt, classified=verdict,
                            error=err, delay_seconds=round(delay, 3))
            console(f"[supervisor] attempt {attempt} failed ({err}); "
                    f"retrying with --resume in {delay:.1f}s")
            sleep(delay)
            attempt += 1
            cfg = dataclasses.replace(cfg, resume=True)
            with _event_writer(cfg) as events:
                events.emit("resume", attempt=attempt,
                            checkpoint_dir=cfg.checkpoint_dir)
            continue
        if attempt:
            with _event_writer(cfg) as events:
                events.emit("supervised_done", attempts=attempt + 1)
        return result


def _scrub_supervisor_argv(argv: List[str]) -> List[str]:
    """Drop the supervisor's own flags from the child argv."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--supervise":
            continue
        if tok in ("--supervise-retries", "--supervise-backoff"):
            skip = True
            continue
        if tok.startswith("--supervise-retries=") \
                or tok.startswith("--supervise-backoff="):
            continue
        out.append(tok)
    return out


def supervise_cli(cfg, argv: List[str],
                  sleep: Callable[[float], None] = time.sleep) -> int:
    """The ``--supervise`` entry: run ``python -m g2vec_tpu_torch``
    children until one succeeds, the policy is spent, or a failure
    classifies fatal. Returns the exit code to hand the shell."""
    policy = _policy_from_cfg(cfg)
    rng = random.Random(cfg.seed)
    child_argv = _scrub_supervisor_argv(list(argv))
    env = dict(os.environ)
    if cfg.fault_plan:
        env[ENV_PLAN] = cfg.fault_plan
    if env.get(ENV_PLAN) and not env.get(ENV_STATE):
        # One-shot faults stay one-shot across child restarts; without a
        # state file shared by the children the same sigkill would fire
        # forever.
        fd, state = tempfile.mkstemp(prefix="g2vec-fault-state-")
        os.close(fd)
        os.unlink(state)        # the fault hook creates it on first fire
        env[ENV_STATE] = state
    attempt = 0
    while True:
        cmd = [sys.executable, "-m", "g2vec_tpu_torch", *child_argv]
        if attempt and "--resume" not in child_argv:
            cmd.append("--resume")
        proc = subprocess.run(cmd, env=env, stderr=subprocess.PIPE, text=True)
        if proc.stderr:
            sys.stderr.write(proc.stderr)
        if proc.returncode == 0:
            if attempt:
                with _event_writer(cfg) as events:
                    events.emit("supervised_done", attempts=attempt + 1)
            return 0
        tail = (proc.stderr or "")[-2000:]
        verdict = classify_child(proc.returncode, tail)
        err = f"child rc={proc.returncode}: {tail[-300:].strip()}"[:500]
        if verdict == "fatal" or attempt >= policy.max_retries:
            with _event_writer(cfg) as events:
                events.emit("gave_up", attempt=attempt, classified=verdict,
                            error=err)
            print(f"[supervisor] giving up after attempt {attempt}: "
                  f"{verdict} — rc={proc.returncode}", file=sys.stderr)
            return proc.returncode if proc.returncode > 0 else 1
        delay = policy.delay(attempt, rng)
        with _event_writer(cfg) as events:
            events.emit("retry", attempt=attempt, classified=verdict,
                        error=err, delay_seconds=round(delay, 3))
        print(f"[supervisor] attempt {attempt} failed "
              f"(rc={proc.returncode}); retrying with --resume in "
              f"{delay:.1f}s", file=sys.stderr)
        sleep(delay)
        attempt += 1
        with _event_writer(cfg) as events:
            events.emit("resume", attempt=attempt,
                        checkpoint_dir=cfg.checkpoint_dir)


def supervise_serve(argv: List[str], *, retries: int = 3,
                    backoff: float = 1.0,
                    metrics_jsonl: Optional[str] = None,
                    state_dir: Optional[str] = None,
                    sleep: Callable[[float], None] = time.sleep) -> int:
    """Watchdog for the ``g2vec serve`` daemon (``g2vec serve --supervise``).

    Relaunches ``python -m g2vec_tpu_torch serve`` (minus the supervisor's own
    flags) until it exits cleanly, a failure classifies fatal, or the
    retry budget runs out — the same policy/classification as
    :func:`supervise_cli`, WITHOUT ``--resume``: the daemon's own journal
    re-queues in-flight jobs on relaunch, and its persistent ``--cache-dir``
    tier restores the walks. The child's stderr goes to
    ``<state_dir>/serve-stderr.log`` (a resident daemon can outlive any
    pipe buffer); its tail feeds the exit classification.
    """
    policy = RetryPolicy(max_retries=retries, backoff_base=backoff)
    rng = random.Random(0)
    child_argv = _scrub_supervisor_argv(list(argv))
    env = dict(os.environ)
    if env.get(ENV_PLAN) or any(a == "--fault-plan"
                                or a.startswith("--fault-plan=")
                                for a in child_argv):
        if not env.get(ENV_STATE):
            # One-shot faults must stay one-shot across daemon restarts
            # (same contract as supervise_cli).
            fd, state = tempfile.mkstemp(prefix="g2vec-fault-state-")
            os.close(fd)
            os.unlink(state)
            env[ENV_STATE] = state

    def _events():
        from g2vec_tpu_torch.utils.metrics import MetricsWriter

        return MetricsWriter(metrics_jsonl, append=True)

    err_log = os.path.join(state_dir, "serve-stderr.log") if state_dir \
        else None
    attempt = 0
    while True:
        cmd = [sys.executable, "-m", "g2vec_tpu_torch", "serve",
               *child_argv]
        if err_log:
            os.makedirs(state_dir, exist_ok=True)
            with open(err_log, "ab") as ef:
                ef.write(f"--- serve attempt {attempt} ---\n".encode())
                ef.flush()
                proc = subprocess.run(cmd, env=env, stderr=ef)
            with open(err_log, "rb") as ef2:
                tail = ef2.read()[-2000:].decode(errors="replace")
        else:
            proc = subprocess.run(cmd, env=env, stderr=subprocess.PIPE,
                                  text=True)
            if proc.stderr:
                sys.stderr.write(proc.stderr)
            tail = (proc.stderr or "")[-2000:]
        if proc.returncode == 0:
            if attempt:
                with _events() as events:
                    events.emit("serve_supervised_done",
                                attempts=attempt + 1)
            return 0
        verdict = classify_child(proc.returncode, tail)
        err = f"serve rc={proc.returncode}: {tail[-300:].strip()}"[:500]
        if verdict == "fatal" or attempt >= policy.max_retries:
            with _events() as events:
                events.emit("gave_up", attempt=attempt, classified=verdict,
                            error=err)
            print(f"[serve-supervisor] giving up after attempt {attempt}: "
                  f"{verdict} — rc={proc.returncode}", file=sys.stderr)
            return proc.returncode if proc.returncode > 0 else 1
        delay = policy.delay(attempt, rng)
        with _events() as events:
            events.emit("serve_relaunch", attempt=attempt,
                        classified=verdict, error=err,
                        delay_seconds=round(delay, 3))
        print(f"[serve-supervisor] daemon died (rc={proc.returncode}, "
              f"{verdict}); relaunching in {delay:.1f}s — journaled jobs "
              f"re-queue on start", file=sys.stderr)
        sleep(delay)
        attempt += 1
