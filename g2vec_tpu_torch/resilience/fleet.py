"""The fleet: heartbeats, collective watchdogs, stage barriers and the
degraded-mesh launcher.

The port's copy of ``g2vec_tpu/resilience/fleet.py``. A multi-process
run does not crash when a peer dies: its next host collective waits for
a value that never comes. The pieces here turn that wait into a named
error and a relaunch:

- **Heartbeats** (:class:`Heartbeat`): a daemon thread per process that
  rewrites ``rank_K.json`` under ``--fleet-liveness-dir`` every
  ``--fleet-heartbeat-interval`` seconds and emits ``heartbeat`` events
  into the run's metrics stream. The file holds the rank's pipeline
  phase and the (name, seq) of the last host collective it entered: the
  record a peer's timeout reads.
- **Collective watchdogs**: the store's collectives
  (:mod:`g2vec_tpu_torch.parallel.hostcomm`) take a deadline of their own
  and name the ranks that never published; :func:`collective_watchdog`
  times out any other blocking call from a sibling thread. Both raise
  :class:`PeerTimeoutError`, a RuntimeError, which the supervisor
  retries.
- **Stage barriers** (:func:`stage_barrier`): after each pipeline stage
  every rank allgathers its stage seconds, so a rank that died mid-stage
  is named at the stage edge, and a rank slower than
  ``--fleet-straggler-factor`` times the median gets a
  ``straggler_warning`` event.
- **Degraded-mesh resume** (:func:`supervise_fleet`): ``--fleet-size R``
  starts R ranks of ``python -m g2vec_tpu_torch --distributed --mesh``,
  and when ranks die re-plans the mesh over the survivors
  (:func:`plan_mesh`) and relaunches them with ``--resume`` from the
  sharded checkpoint. The port's ranks share one card: each holds the
  whole replicated state on it (:func:`.parallel.distributed.
  shared_card_fleet`), so the restored leaves need no resharding.

With no ``--fleet-*`` flag all of it is inert: no heartbeat thread, no
deadline, and no barrier in a single-process run. This module imports
no torch: the launcher holds no CUDA context.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from g2vec_tpu_torch.resilience.faults import (ENV_PLAN, ENV_STATE,
                                               current_rank, fault_point)


class PeerTimeoutError(RuntimeError):
    """A watched collective missed its deadline; ``suspects`` holds the
    rank(s) that never arrived (empty when none could be named). A
    RuntimeError, as in the reference: peer death is preemption-shaped,
    so the supervisor retries it."""

    def __init__(self, message: str, *, collective: Optional[str] = None,
                 suspects: Tuple[int, ...] = ()):
        super().__init__(message)
        self.collective = collective
        self.suspects = suspects


@dataclasses.dataclass
class FleetConfig:
    """Process-wide fleet knobs (all off by default)."""

    liveness_dir: Optional[str] = None
    heartbeat_interval: float = 0.0   # seconds; 0 = no heartbeat thread
    watchdog_deadline: float = 0.0    # seconds; 0 = block
    straggler_factor: float = 0.0     # x median; 0 = no straggler warnings


_config = FleetConfig()
_heartbeat: Optional["Heartbeat"] = None


def configure(cfg: Optional[FleetConfig] = None, **kwargs) -> FleetConfig:
    """Install the process's fleet config (``pipeline.run`` calls this
    once per run)."""
    global _config
    _config = dataclasses.replace(cfg or FleetConfig(), **kwargs)
    return _config


def config() -> FleetConfig:
    return _config


def _nranks() -> int:
    """The run's rank count: an initialized multi-process run's, else
    ``G2VEC_NUM_PROCESSES``, else 1."""
    dist = sys.modules.get("g2vec_tpu_torch.parallel.distributed")
    if dist is not None and dist.initialized():
        return dist.process_count()
    nproc = os.environ.get("G2VEC_NUM_PROCESSES")
    return int(nproc) if nproc and nproc.isdigit() else 1


def liveness_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank_{rank}.json")


def read_liveness(directory: str, rank: int) -> Optional[dict]:
    try:
        with open(liveness_path(directory, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def describe_ranks(ranks: Sequence[int],
                   directory: Optional[str] = None) -> str:
    """What the liveness files say of ``ranks``: a stale or absent beat
    (a dead process) or a fresh one (a live straggler), with each rank's
    phase and last collective. Empty with no liveness directory."""
    directory = directory or _config.liveness_dir
    if not directory:
        return ""
    now = time.time()
    bits = []
    for r in ranks:
        rec = read_liveness(directory, r)
        if rec is None:
            bits.append(f"rank {r}: no liveness record")
            continue
        age = now - float(rec.get("ts", 0.0))
        state = ("heartbeat stale" if age > _stale_after() else
                 "heartbeat fresh — live straggler?")
        bits.append(f"rank {r}: {state} (last beat {age:.1f}s ago, "
                    f"phase={rec.get('phase')!r}, last collective="
                    f"{rec.get('collective')!r} "
                    f"seq {rec.get('collective_seq')})")
    return " [" + "; ".join(bits) + "]"


def _stale_after() -> float:
    # Three missed beats mean dead, with a floor for coarse intervals.
    return max(3.0 * (_config.heartbeat_interval or 1.0), 5.0)


class Heartbeat:
    """A process's liveness beacon (a daemon thread).

    Each beat passes the ``heartbeat`` fault seam (a failure there ends
    only the thread: a host whose monitoring died first), rewrites this
    rank's liveness file atomically and emits a ``heartbeat`` event into
    ``metrics`` (a no-op writer on ranks other than 0, whose liveness is
    the file alone).
    """

    def __init__(self, directory: str, interval: float, metrics=None,
                 rank: Optional[int] = None):
        self.directory = directory
        self.interval = interval
        self.metrics = metrics
        self.rank = current_rank() if rank is None else rank
        self.beats = 0
        self.phase = "start"
        self.collective: Optional[str] = None
        self.collective_seq: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- on the main thread --
    def start(self) -> "Heartbeat":
        os.makedirs(self.directory, exist_ok=True)
        self.beat()                      # the file exists before any wait
        self._thread = threading.Thread(
            target=self._loop, name=f"g2vec-heartbeat-{self.rank}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.interval))
            self._thread = None

    def note(self, phase: str) -> None:
        self.phase = phase

    def note_collective(self, name: str, seq: int) -> None:
        self.collective, self.collective_seq = name, seq
        self.beat()      # peers must see the entry at once

    def beat(self) -> None:
        record = {"rank": self.rank, "pid": os.getpid(), "ts": time.time(),
                  "beats": self.beats, "phase": self.phase,
                  "collective": self.collective,
                  "collective_seq": self.collective_seq,
                  "interval": self.interval}
        path = liveness_path(self.directory, self.rank)
        # The main thread (note_collective) and the beat thread may both
        # write: a temporary file each.
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
        if self.metrics is not None:
            self.metrics.emit("heartbeat", **{k: v for k, v in record.items()
                                              if k != "ts"})
        self.beats += 1

    # -- the thread --
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                fault_point("heartbeat")
                self.beat()
            except Exception:  # noqa: BLE001 — the beats stop, not the run
                # "Monitoring died": the thread ends, the file goes stale,
                # and peers start naming this rank on a timeout.
                return


def start_heartbeat(metrics=None) -> Optional[Heartbeat]:
    """Start the process's heartbeat under the installed config (None when
    it is off); replaces a previous one (a supervised re-entry)."""
    global _heartbeat
    stop_heartbeat()
    if not _config.liveness_dir or _config.heartbeat_interval <= 0:
        return None
    _heartbeat = Heartbeat(_config.liveness_dir,
                           _config.heartbeat_interval, metrics).start()
    return _heartbeat


def stop_heartbeat() -> None:
    global _heartbeat
    if _heartbeat is not None:
        _heartbeat.stop()
        _heartbeat = None


def current_heartbeat() -> Optional[Heartbeat]:
    return _heartbeat


def note_phase(phase: str) -> None:
    if _heartbeat is not None:
        _heartbeat.note(phase)


def note_collective(name: str, seq: int) -> None:
    """Record in this rank's liveness file that it entered a collective:
    what the watchdogs of the OTHER ranks read on a timeout."""
    if _heartbeat is not None:
        _heartbeat.note_collective(name, seq)


def collective_watchdog(name: str, fn: Callable[[], object], *,
                        deadline: Optional[float] = None):
    """Run a blocking call ``fn`` under a timeout.

    ``fn`` runs on a sibling thread; past the deadline the suspects are
    read from the peers' liveness files and :class:`PeerTimeoutError` is
    raised here. The abandoned thread blocks on harmlessly: the process
    is about to be torn down. ``deadline=None`` takes the configured
    ``watchdog_deadline``; 0 runs ``fn`` inline.
    """
    deadline = _config.watchdog_deadline if deadline is None else deadline
    seq = -1
    hb = _heartbeat
    if hb is not None:
        seq = (hb.collective_seq or 0) + 1
        hb.note_collective(name, seq)
    if not deadline:
        return fn()
    result: dict = {}
    done = threading.Event()

    def _run():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            result["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_run, name=f"g2vec-collective-{name}",
                         daemon=True)
    t.start()
    if not done.wait(deadline):
        suspects = _liveness_suspects(name, seq)
        raise PeerTimeoutError(
            f"collective {name!r} exceeded its {deadline:.1f}s watchdog "
            f"deadline; suspect rank(s): {list(suspects) or 'unknown'}"
            + describe_ranks(suspects),
            collective=name, suspects=suspects)
    if "error" in result:
        raise result["error"]
    return result.get("value")


def _liveness_suspects(name: str, seq: int) -> Tuple[int, ...]:
    """The ranks that, by their liveness files, never reached collective
    ``(name, seq)`` or whose heartbeat went stale."""
    directory = _config.liveness_dir
    if not directory or seq < 0:
        return ()
    me, now, suspects = current_rank(), time.time(), []
    for peer in range(_nranks()):
        if peer == me:
            continue
        rec = read_liveness(directory, peer)
        if rec is None:
            suspects.append(peer)
            continue
        stale = (now - float(rec.get("ts", 0.0))) > _stale_after()
        behind = (rec.get("collective_seq") is None
                  or int(rec["collective_seq"]) < seq
                  or (int(rec["collective_seq"]) == seq
                      and rec.get("collective") != name))
        if stale or behind:
            suspects.append(peer)
    return tuple(suspects)


def stage_barrier(stage: str, seconds: float, metrics=None,
                  console: Optional[Callable[[str], None]] = None) -> None:
    """The per-stage barrier and straggler check. COLLECTIVE (every rank,
    the same stage order); a no-op in a single process, or when the fleet
    config turns on neither the watchdog nor straggler warnings.

    Allgathers every rank's stage seconds under the watchdog deadline, so
    a rank that died mid-stage is named here by a PeerTimeoutError, and
    flags ranks slower than ``straggler_factor`` x the median with a
    ``straggler_warning`` event.
    """
    if _nranks() <= 1:
        return
    if not (_config.watchdog_deadline or _config.straggler_factor):
        return
    import numpy as np

    from g2vec_tpu_torch.parallel import hostcomm

    fault_point("stage_barrier")
    note_phase(f"barrier:{stage}")
    durations = hostcomm.allgather_array(
        f"stage/{stage}", np.asarray([seconds], dtype=np.float64),
        deadline=_config.watchdog_deadline or None).reshape(-1)
    if not _config.straggler_factor:
        return
    median = float(np.median(durations))
    threshold = max(_config.straggler_factor * median, median + 0.05)
    for peer, dur in enumerate(durations):
        if float(dur) > threshold:
            if metrics is not None:
                metrics.emit("straggler_warning", stage=stage, rank=peer,
                             seconds=round(float(dur), 4),
                             median_seconds=round(median, 4),
                             factor=_config.straggler_factor)
            if console is not None:
                console(f"[fleet] straggler warning: rank {peer} took "
                        f"{float(dur):.2f}s in stage {stage!r} "
                        f"(median {median:.2f}s)")


# --------------------------------------------------------------- mesh plan

def plan_mesh(n_devices: int, prefer_model: int = 1) -> Tuple[int, int]:
    """The largest valid ``(data, model)`` factorization of ``n_devices``:
    the model axis as large as it can be without passing ``prefer_model``
    (gene shards may merge when a rank dies, never grow), the data axis
    the rest, so that ``data * model == n_devices``."""
    if n_devices < 1:
        raise ValueError(f"cannot plan a mesh over {n_devices} devices")
    prefer_model = max(1, prefer_model)
    model = max(d for d in range(1, min(prefer_model, n_devices) + 1)
                if n_devices % d == 0)
    return (n_devices // model, model)


# ------------------------------------------------------- fleet supervisor

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrub_fleet_argv(argv: List[str]) -> List[str]:
    """A rank's argv: the CLI's without the launcher's own flags (fleet
    sizing, supervision, the fault plan, which travels in the environment
    so that what fired survives relaunches) and without --mesh/--resume,
    which the launcher sets per attempt."""
    launcher_flags = ("--fleet-size", "--fleet-devices-per-rank",
                      "--supervise-retries", "--supervise-backoff",
                      "--fault-plan", "--mesh")
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in ("--supervise", "--resume"):
            continue
        if tok in launcher_flags:
            skip = True
            continue
        if any(tok.startswith(f + "=") for f in launcher_flags):
            continue
        out.append(tok)
    return out


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def rank_device_count(device: str) -> int:
    """The devices one rank sees for ``device``: 1 for the CPU; for cuda,
    torch's card count, asked in a child interpreter so that the launcher
    imports no torch."""
    if device.split(":")[0] == "cpu":
        return 1
    probe = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.cuda.device_count())"],
        capture_output=True, text=True)
    try:
        return int(probe.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return 0


def supervise_fleet(cfg, argv: List[str],
                    sleep: Callable[[float], None] = time.sleep) -> int:
    """Launch and supervise a ``--fleet-size`` run with degraded-mesh
    resume; returns the exit code for the shell.

    Each attempt starts one ``python -m g2vec_tpu_torch`` child per rank,
    with the coordinator address, its rank and the rank count in the
    ``G2VEC_*`` environment; the ranks share the card (or the CPU) and
    inherit ``--device``. When the attempt fails, the ranks that died by a
    signal or wedged (still running after one watchdog window) are
    dropped, the mesh is re-planned over the survivors' devices
    (:func:`plan_mesh`), and the fleet relaunches with ``--resume`` (with
    ``--checkpoint-dir``, which then needs ``--checkpoint-layout sharded``:
    config.validate says so).
    """
    import random

    from g2vec_tpu_torch.resilience.supervisor import (RetryPolicy,
                                                       _event_writer,
                                                       classify_child)

    ranks = cfg.fleet_size
    mesh = cfg.mesh_shape or (ranks * max(1, cfg.fleet_devices_per_rank
                                           or 1), 1)
    devices_per_rank = cfg.fleet_devices_per_rank or \
        max(1, (mesh[0] * mesh[1]) // ranks)
    # In place of the reference's virtual CPU devices per rank: a rank
    # holds only what this host shows it.
    visible = rank_device_count(cfg.device)
    if devices_per_rank > visible:
        raise ValueError(
            f"the fleet needs {devices_per_rank} devices per rank (mesh "
            f"{mesh[0]}x{mesh[1]} over {ranks} ranks), only {visible} "
            f"visible on {cfg.device!r}; the ranks share this host's "
            f"devices")
    policy = RetryPolicy(max_retries=cfg.supervise_retries,
                         backoff_base=cfg.supervise_backoff)
    rng = random.Random(cfg.seed)
    base_argv = _scrub_fleet_argv(list(argv))
    liveness = cfg.fleet_liveness_dir or tempfile.mkdtemp(
        prefix="g2vec-fleet-liveness-")
    if not cfg.fleet_liveness_dir \
            and "--fleet-liveness-dir" not in " ".join(base_argv):
        base_argv += ["--fleet-liveness-dir", liveness]
    state_dir = tempfile.mkdtemp(prefix="g2vec-fleet-fault-state-")
    try:
        attempt = 0
        resume = bool(cfg.resume)
        while True:
            port = _free_port()
            log_dir = os.path.join(liveness, f"logs-attempt{attempt}")
            os.makedirs(log_dir, exist_ok=True)
            with _event_writer(cfg) as events:
                events.emit("fleet_launch", attempt=attempt, ranks=ranks,
                            mesh=list(mesh), devices_per_rank=devices_per_rank,
                            resume=resume)
            procs: List[subprocess.Popen] = []
            errs: List[str] = []
            handles: List = []
            for r in range(ranks):
                env = dict(os.environ)
                env["G2VEC_COORDINATOR"] = f"127.0.0.1:{port}"
                env["G2VEC_PROCESS_ID"] = str(r)
                env["G2VEC_NUM_PROCESSES"] = str(ranks)
                if cfg.fault_plan:
                    env[ENV_PLAN] = cfg.fault_plan
                    # A state file per rank: a one-shot fault on rank 0 must
                    # not be spent because rank 1 fired its own copy.
                    env[ENV_STATE] = os.path.join(state_dir, f"rank{r}.json")
                cmd = [sys.executable, "-m", "g2vec_tpu_torch", *base_argv,
                       "--distributed", "--mesh", f"{mesh[0]}x{mesh[1]}"]
                if resume:
                    cmd.append("--resume")
                err_path = os.path.join(log_dir, f"rank{r}.err")
                errs.append(err_path)
                out_f = open(os.path.join(log_dir, f"rank{r}.out"), "w")
                err_f = open(err_path, "w")
                handles += [out_f, err_f]
                procs.append(subprocess.Popen(cmd, env=env, stdout=out_f,
                                              stderr=err_f))
            # ---- watch the attempt ----
            failed = False
            while True:
                codes = [p.poll() for p in procs]
                if any(c is not None and c != 0 for c in codes):
                    failed = True
                    break
                if all(c == 0 for c in codes):
                    break
                sleep(0.1)
            wedged: List[int] = []
            died: List[int] = []
            if failed:
                # The first casualty's peers usually exit by themselves with a
                # PeerTimeoutError: give them one watchdog window.
                grace = (cfg.fleet_watchdog_deadline or 5.0) + 5.0
                t_end = time.monotonic() + grace
                while time.monotonic() < t_end \
                        and any(p.poll() is None for p in procs):
                    sleep(0.1)
                for r, p in enumerate(procs):
                    if p.poll() is None:
                        wedged.append(r)
                        p.send_signal(signal.SIGTERM)
                for p in procs:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                died = [r for r, p in enumerate(procs)
                        if p.returncode is not None and p.returncode < 0
                        and r not in wedged]
            for h in handles:
                h.close()
            if not failed:
                with _event_writer(cfg) as events:
                    events.emit("fleet_done", attempts=attempt + 1,
                                ranks=ranks, mesh=list(mesh))
                return 0
            # ---- classify and re-plan ----
            tails = {r: _tail(e) for r, e in enumerate(errs)}
            for r, t in tails.items():
                if procs[r].returncode != 0 and t:
                    sys.stderr.write(f"[fleet] rank {r} (rc="
                                     f"{procs[r].returncode}) stderr tail:\n"
                                     f"{t[-1200:]}\n")
            lost = sorted(set(died) | set(wedged))
            survivors = [r for r in range(ranks) if r not in lost]
            verdicts = [classify_child(procs[r].returncode or 1,
                                       tails.get(r, ""))
                        for r in range(ranks) if procs[r].returncode != 0]
            verdict = "fatal" if "fatal" in verdicts else "retryable"
            rcs = {r: procs[r].returncode for r in range(ranks)}
            with _event_writer(cfg) as events:
                events.emit("fleet_peer_death", attempt=attempt,
                            dead_ranks=lost, wedged_ranks=wedged,
                            returncodes={str(k): v for k, v in rcs.items()},
                            classified=verdict)
            if verdict == "fatal" or attempt >= policy.max_retries \
                    or not survivors:
                with _event_writer(cfg) as events:
                    events.emit("gave_up", attempt=attempt, classified=verdict,
                                error=f"fleet ranks failed: rcs={rcs}")
                print(f"[fleet] giving up after attempt {attempt}: "
                      f"{verdict} — rcs={rcs}", file=sys.stderr)
                bad = [rc for rc in rcs.values() if rc and rc > 0]
                return bad[0] if bad else 1
            new_ranks = len(survivors) if lost else ranks
            new_devices = new_ranks * devices_per_rank
            new_mesh = plan_mesh(new_devices, prefer_model=mesh[1])
            delay = policy.delay(attempt, rng)
            with _event_writer(cfg) as events:
                events.emit("fleet_replan", attempt=attempt,
                            surviving_ranks=new_ranks,
                            surviving_devices=new_devices,
                            old_mesh=list(mesh), new_mesh=list(new_mesh),
                            delay_seconds=round(delay, 3))
            print(f"[fleet] attempt {attempt} lost rank(s) "
                  f"{lost or '(none)'}; re-planning mesh "
                  f"{mesh[0]}x{mesh[1]} -> {new_mesh[0]}x{new_mesh[1]} over "
                  f"{new_ranks} rank(s); relaunching with --resume in "
                  f"{delay:.1f}s", file=sys.stderr)
            sleep(delay)
            attempt += 1
            # Stale liveness of dropped ranks must not mislead the next
            # attempt's attribution (the survivors renumber from 0).
            for r in range(new_ranks, ranks):
                try:
                    os.unlink(liveness_path(liveness, r))
                except OSError:
                    pass
            ranks, mesh = new_ranks, new_mesh
            resume = bool(cfg.checkpoint_dir)
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
        if not cfg.fleet_liveness_dir:
            # The launcher made it; a failed rank's stderr tail was
            # printed above. A directory the user named is kept.
            shutil.rmtree(liveness, ignore_errors=True)
