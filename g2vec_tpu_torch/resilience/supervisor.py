"""Auto-resume supervision: bounded retries around ``pipeline.run``.

The port's copy of ``g2vec_tpu/resilience/supervisor.py``. Three entry
points with one retry policy, and the router's process manager
(:class:`ReplicaFleet`):

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


# ---------------------------------------------------------------------------
# Fleet-of-daemons supervision — the router's process-management substrate.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplicaSpec:
    """One serve replica: its directory layout plus the live handle.

    ``proc`` is a Popen when this fleet launched the replica; after a
    router restart an *adopted* replica has only ``pid`` (learned from
    its ``/status``) — fencing handles both. ``boot_error`` holds why
    the last launch died before it listened (its rc and log tail), and
    is cleared by a launch that comes up: the router does not relaunch
    such a replica on its own.

    Concurrency: the fleet/spec objects carry no lock of their own. The
    mutable fields below are guarded EXTERNALLY by the router's
    per-replica lock (the dotted guarded-by form is documentation-only
    to the lock-discipline checker — it records the contract without
    pretending to verify a lock it cannot see from this file)."""

    name: str
    dir: str
    socket_path: str
    state_dir: str
    log_path: str
    addr: Optional[str] = None          # guarded-by: Router._rep_locks
    pid: Optional[int] = None           # guarded-by: Router._rep_locks
    proc: Optional[object] = None       # guarded-by: Router._rep_locks
    boots: int = 0                      # guarded-by: Router._rep_locks
    exits: int = 0                      # guarded-by: Router._rep_locks
    #: False for a replica on another host (or behind a relay): its
    #: death can never be verified from here — fence() must not kill a
    #: recycled local pid, and the router must quarantine via a fence
    #: marker instead of trusting SIGKILL.
    local: bool = True                  # guarded-by: Router._rep_locks
    boot_error: Optional[str] = None    # guarded-by: Router._rep_locks


class ReplicaBootError(RuntimeError):
    """A replica process exited before its TCP listener came up (a
    daemon that finds no card exits so at start). The message carries
    the exit code and the tail of the replica's log."""


class ReplicaFleet:
    """Launch/adopt/fence/relaunch N ``python -m g2vec_tpu_torch serve``
    daemon children. The device is the replicas' own: whatever
    ``serve_argv`` says (``--device cpu``), else the card, and a replica
    that finds no card fails its boot (:class:`ReplicaBootError`).

    Layout: ``<fleet_dir>/<name>/`` holds ``sock`` (UNIX socket),
    ``state/`` (the daemon's durable state dir — journal, results,
    ckpt), and ``serve.log`` (stderr). Each replica also gets a TCP
    listener on an ephemeral port, discovered via the daemon's
    ``<state>/tcp_addr`` file.

    The fleet does NOT auto-relaunch a dead replica — that is the
    router's call, *after* it has fenced the corpse and migrated its
    journal (relaunch-before-migrate would resurrect the stale journal
    and double-run jobs). ``supervise_serve`` above remains the
    single-daemon watchdog; this class is deliberately dumber.
    """

    def __init__(self, fleet_dir: str, n: int,
                 serve_argv: Optional[List[str]] = None,
                 listen_host: str = "127.0.0.1",
                 env: Optional[dict] = None,
                 console: Callable[[str], None] = print):
        if n < 1:
            raise ValueError("fleet needs n >= 1 replicas")
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.listen_host = listen_host
        self.serve_argv = list(serve_argv or [])
        self.env = dict(env) if env is not None else dict(os.environ)
        self.console = console
        #: name -> ReplicaSpec. The dict shape is fixed at construction;
        #: per-spec mutation happens under Router._rep_locks[name].
        # guarded-by: Router._rep_locks
        self.replicas: dict = {}
        for i in range(n):
            name = f"r{i}"
            rdir = os.path.join(self.fleet_dir, name)
            self.replicas[name] = ReplicaSpec(
                name=name, dir=rdir,
                socket_path=os.path.join(rdir, "sock"),
                state_dir=os.path.join(rdir, "state"),
                log_path=os.path.join(rdir, "serve.log"))

    def names(self) -> List[str]:
        return list(self.replicas)

    def replica(self, name: str) -> ReplicaSpec:
        return self.replicas[name]

    def _addr_file(self, spec: ReplicaSpec) -> str:
        return os.path.join(spec.state_dir, "tcp_addr")

    def launch(self, name: str, wait_ready_s: float = 90.0) -> ReplicaSpec:
        """Spawn one replica and wait for its TCP listener to come up
        (the daemon writes ``<state>/tcp_addr`` at bind time)."""
        spec = self.replicas[name]
        os.makedirs(spec.state_dir, exist_ok=True)
        # Never boot a successor over an unfenced predecessor: a zombie
        # replica this fleet object has no handle for (router restarted,
        # probe timed out so it was never adopted) would race the new
        # process on the same journal. fence() falls back to the
        # daemon's own pidfile, so this reaches even unknown pids.
        self.fence(name, grace_s=0.0)
        try:
            os.unlink(self._addr_file(spec))    # never read a stale addr
        except OSError:
            pass
        # A successor on this state dir boots UNFENCED: the quarantine
        # marker that parked the predecessor (serve/leader.py) must not
        # instantly park the fresh daemon. The router clears it on its
        # own relaunch path too; this covers manual/boot launches.
        from g2vec_tpu_torch.serve.leader import clear_fence_marker

        clear_fence_marker(spec.state_dir)
        cmd = [sys.executable, "-m", "g2vec_tpu_torch", "serve",
               "--socket", spec.socket_path,
               "--state-dir", spec.state_dir,
               "--listen", f"{self.listen_host}:0",
               # Per-replica stream (a later --metrics-jsonl in serve_argv
               # overrides): fleet-wide accounting scans every replica's
               # file, so two processes never interleave one JSONL.
               "--metrics-jsonl", os.path.join(spec.dir, "metrics.jsonl"),
               *self.serve_argv]
        logf = open(spec.log_path, "ab")
        logf.write(f"--- boot {spec.boots} ---\n".encode())
        logf.flush()
        spec.proc = subprocess.Popen(cmd, env=self.env, stderr=logf,
                                     stdout=logf)
        logf.close()        # child holds the fd
        spec.pid = spec.proc.pid
        spec.boots += 1
        deadline = time.monotonic() + wait_ready_s
        addr_file = self._addr_file(spec)
        while time.monotonic() < deadline:
            if os.path.exists(addr_file):
                with open(addr_file) as fh:
                    spec.addr = fh.read().strip()
                if spec.addr:
                    spec.boot_error = None
                    return spec
            if spec.proc.poll() is not None:
                spec.boot_error = (
                    f"replica {name} died during boot "
                    f"(rc={spec.proc.returncode}); see {spec.log_path}: "
                    f"{self._log_tail(spec)}")
                spec.proc = None
                spec.pid = None
                raise ReplicaBootError(spec.boot_error)
            time.sleep(0.05)
        raise TimeoutError(f"replica {name} TCP listener not up within "
                           f"{wait_ready_s:.0f}s; see {spec.log_path}")

    @staticmethod
    def _log_tail(spec: "ReplicaSpec", limit: int = 600) -> str:
        """The last ``limit`` characters this boot wrote to the log."""
        try:
            with open(spec.log_path, "rb") as fh:
                text = fh.read().decode("utf-8", "replace")
        except OSError:
            return ""
        marker = f"--- boot {spec.boots - 1} ---\n"
        if marker in text:
            text = text[text.rindex(marker) + len(marker):]
        return text[-limit:].strip()

    def adopt(self, name: str, pid: int, addr: Optional[str],
              local: bool = True) -> ReplicaSpec:
        """Record an already-running replica (router restart: the daemons
        survived, only the router died). Fencing falls back to
        ``os.kill`` since the process is not our child; ``local=False``
        marks a replica whose process lives beyond this host's reach
        (remote or relayed), so fencing can only ever be advisory."""
        spec = self.replicas[name]
        spec.proc = None
        spec.pid = pid
        spec.local = local
        if addr:
            spec.addr = addr
        elif os.path.exists(self._addr_file(spec)):
            with open(self._addr_file(spec)) as fh:
                spec.addr = fh.read().strip()
        return spec

    def alive(self, name: str) -> bool:
        spec = self.replicas[name]
        if spec.proc is not None:
            return spec.proc.poll() is None
        if spec.pid is None:
            return False
        if not spec.local:
            # A remote pid means nothing to this host's process table;
            # only the router's network probes can judge it. Having a
            # pid at all means it was adopted alive.
            return True
        try:
            os.kill(spec.pid, 0)
            return True
        except OSError:
            return False

    def _pidfile_pid(self, spec: "ReplicaSpec") -> Optional[int]:
        """The pid the daemon recorded in ``<state>/serve.pid`` — the
        fence target of last resort for a replica this fleet object
        never launched or adopted. Verified against the process's
        cmdline (must mention this replica's state dir) so a recycled
        pid is never killed; a clean daemon exit unlinks the file."""
        path = os.path.join(spec.state_dir, "serve.pid")
        try:
            with open(path) as fh:
                pid = int(fh.read().strip())
        except (OSError, ValueError):
            return None
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmdline = fh.read().decode("utf-8", "replace")
        except OSError:
            return None
        return pid if spec.state_dir in cmdline else None

    def fence(self, name: str, grace_s: float = 2.0) -> Optional[int]:
        """Guarantee the replica process is dead before its journal is
        migrated — a slow-but-alive replica must never race a survivor
        on the same job. Waits up to ``grace_s`` for a natural exit,
        then SIGKILLs. Returns the exit code when known (negative =
        killed by that signal), None for a non-child — None means the
        caller has NO local proof of death, which is what separates a
        verified-dead failover from a false-dead quarantine."""
        import signal as _signal

        spec = self.replicas[name]
        rc: Optional[int] = None
        if not spec.local:
            # The process lives on another host: os.kill here would hit
            # a recycled local pid at best. Death is unverifiable.
            spec.proc = None
            spec.pid = None
            spec.exits += 1
            return None
        if spec.proc is None and spec.pid is None:
            spec.pid = self._pidfile_pid(spec)
        if spec.proc is not None:
            try:
                rc = spec.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                spec.proc.kill()
                rc = spec.proc.wait(timeout=10.0)
            spec.proc = None
        elif spec.pid is not None:
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline:
                try:
                    os.kill(spec.pid, 0)
                except OSError:
                    break
                time.sleep(0.05)
            try:
                os.kill(spec.pid, _signal.SIGKILL)
            except OSError:
                pass
            # Non-child: poll until the pid is gone (bounded).
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                try:
                    os.kill(spec.pid, 0)
                    time.sleep(0.05)
                except OSError:
                    break
        spec.pid = None
        spec.exits += 1
        return rc

    def relaunch(self, name: str, wait_ready_s: float = 90.0) -> ReplicaSpec:
        """Fence (idempotent if already dead) then boot a fresh process
        on the same state dir — the journal recovery + idem table
        restore on boot are what make this safe."""
        self.fence(name, grace_s=0.0)
        return self.launch(name, wait_ready_s=wait_ready_s)

    def stop_all(self, grace_s: float = 30.0) -> None:
        import signal as _signal

        for spec in self.replicas.values():
            if not spec.local:
                continue        # not ours to signal
            if spec.proc is not None and spec.proc.poll() is None:
                spec.proc.send_signal(_signal.SIGTERM)
            else:
                if spec.pid is None:
                    spec.pid = self._pidfile_pid(spec)
                if spec.pid is not None:
                    try:
                        os.kill(spec.pid, _signal.SIGTERM)
                    except OSError:
                        pass
        deadline = time.monotonic() + grace_s
        for name in self.names():
            self.fence(name, grace_s=max(0.0,
                                         deadline - time.monotonic()))
