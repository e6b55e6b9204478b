"""Chaos soak for the port: a seeded fault storm against
``python -m g2vec_tpu_torch serve``, with exactly-once accounting.

The port's counterpart of the JAX package's ``tools/chaos_soak.py``,
run as ``python -m g2vec_tpu_torch.tools.chaos_soak``. Every daemon it
starts runs ``--device {cuda|cpu}`` (``--device``, default cuda); the
byte-parity oracle is the port's own solo run
(:func:`g2vec_tpu_torch.pipeline.run`) on the same device.

The harness is the supervisor: it launches the daemon as a child
(unsupervised, so drain exit codes are observable), drives a seeded
Poisson schedule of job arrivals (full-batch and streaming jobs,
tenants, priorities, some with tight deadlines), and injects a seeded
rotation of faults while the jobs run:

- ``sigkill``: SIGKILL the daemon mid-whatever; relaunch immediately.
- ``drain``: SIGTERM; the daemon must exit 0 with in-flight streaming
  jobs checkpointed and everything unfinished journaled.
- ``fault:*``: drain, then relaunch with a ``--fault-plan`` armed at a
  durable seam (``stream_ckpt``/``train`` sigkill, ``drain`` crash) and
  a fresh ``G2VEC_FAULT_STATE`` file so each injection fires once.
- ``cancel``: client-cancel a random not-yet-terminal job.

After the storm a clean daemon quiesces the backlog. The soak passes
iff every acknowledged job reaches exactly one terminal state (done /
cancelled / deadline_exceeded; ``failed`` counts but fails the soak),
no job is lost (acknowledged but never recorded) or duplicated (more
than one terminal ``job_state`` event), the journal is empty, and a
sample of completed jobs is byte-identical to solo uninterrupted runs.

``--replicas N`` storms a TCP router over N daemon replicas
(serve/router.py): replica SIGKILL (the router must fence, migrate the
journal and relaunch), synchronous replica drain (rc 0), and router
SIGKILL + restart (the new router adopts the live replicas). The same
exactly-once predicate is computed fleet-wide, plus the death-to-
requeue latencies of the router's ``failover`` events.

``--autoscale`` runs a seeded diurnal load with flash crowds and tenant
SLO classes against an elastic (``--max-replicas`` > min, warm spares,
``--shed``, ``--tenant-quotas``) or static fleet, with one replica
SIGKILL mid-spike; the summary adds per-tenant SLO attainment, deadline
deaths, shed counts, goodput and the scale-up reaction times.

``--partition`` is the control-plane drill: the harness owns the
replicas (the router runs ``--remote-replicas``) and puts a TCP relay
(:class:`_Relay`) in front of r0 that can blackhole each direction.
(1) false-dead: r0 is partitioned while alive; the leased router must
fence it (epoch bump + marker) and migrate its journal, and r0 must
quarantine itself and stay out of the ring after the heal; (2) zombie
leader: the active router is SIGSTOPped past its lease ttl, the standby
takes over, and every mutating command the woken zombie emits must die
with ``stale_epoch``; (3) a chain of ``--takeovers`` router SIGKILLs,
each gap carrying a degraded-mode client drill.

Scale knobs are flags with G2V_CHAOS_* env fallbacks, so a test can
shrink the soak (``G2V_CHAOS_JOBS=6 python -m
g2vec_tpu_torch.tools.chaos_soak --device cpu``). The summary JSON is
printed last and, with ``--json PATH``, written there.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

#: The checkout the soak runs from: its children get it on PYTHONPATH.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TERMINAL_STATES = ("done", "failed", "cancelled", "deadline_exceeded")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="chaos_soak",
        description="Seeded fault storm against g2vec_tpu_torch serve "
                    "with "
                    "exactly-once job accounting.")
    p.add_argument("--jobs", type=int,
                   default=_env_int("G2V_CHAOS_JOBS", 50))
    p.add_argument("--seed", type=int,
                   default=_env_int("G2V_CHAOS_SEED", 0))
    p.add_argument("--device", type=str, choices=("cuda", "cpu"),
                   default=os.environ.get("G2V_CHAOS_DEVICE", "cuda"),
                   help="Device of every daemon and of the solo twins "
                        "(default cuda; a daemon that finds no card "
                        "fails its boot, and the soak with it).")
    p.add_argument("--epochs", type=int,
                   default=_env_int("G2V_CHAOS_EPOCHS", 8),
                   help="Base epoch count per job (jittered per job).")
    p.add_argument("--mean-arrival", type=float,
                   default=_env_float("G2V_CHAOS_ARRIVAL", 0.4),
                   help="Mean exponential interarrival seconds.")
    p.add_argument("--chaos-ops", type=int,
                   default=_env_int("G2V_CHAOS_OPS", 0),
                   help="Fault injections over the soak (0 = jobs//8, "
                        "min 3).")
    p.add_argument("--chaos-every", type=float,
                   default=_env_float("G2V_CHAOS_EVERY", 7.0),
                   help="Mean seconds between fault injections.")
    p.add_argument("--stream-frac", type=float,
                   default=_env_float("G2V_CHAOS_STREAM_FRAC", 0.4),
                   help="Fraction of streaming jobs (needs g++; 0 if "
                        "no native toolchain).")
    p.add_argument("--verify", type=int,
                   default=_env_int("G2V_CHAOS_VERIFY", 4),
                   help="Completed jobs to byte-compare against solo "
                        "uninterrupted twins.")
    p.add_argument("--budget-s", type=float,
                   default=_env_float("G2V_CHAOS_BUDGET", 900.0),
                   help="Hard wall-clock budget for the whole soak.")
    p.add_argument("--workdir", type=str, default=None,
                   help="Working directory (default: a fresh tempdir, "
                        "removed unless --keep).")
    p.add_argument("--keep", action="store_true",
                   help="Keep the workdir (logs, metrics, outputs).")
    p.add_argument("--json", type=str, default=None, metavar="PATH",
                   help="Also write the summary JSON here.")
    p.add_argument("--replicas", type=int,
                   default=_env_int("G2V_CHAOS_REPLICAS", 0),
                   help="Router mode: storm a replicated fleet behind the "
                        "TCP router instead of one daemon. Op rotation "
                        "becomes replica SIGKILL / synchronous replica "
                        "drain / router SIGKILL+restart / cancel; "
                        "accounting spans every replica's results dir and "
                        "metrics stream (0 = classic single-daemon mode).")
    p.add_argument("--autoscale", action="store_true",
                   default=_env_int("G2V_CHAOS_AUTOSCALE", 0) > 0,
                   help="Autoscale mode: seeded diurnal/burst load with "
                        "tenant SLO classes against the router (elastic "
                        "when --max-replicas > min, static otherwise), "
                        "one replica SIGKILL mid-spike, aggregate-status "
                        "assertions, per-tenant attainment accounting.")
    p.add_argument("--min-replicas", type=int,
                   default=_env_int("G2V_CHAOS_MIN_REPLICAS", 0),
                   help="Elastic floor forwarded to the router "
                        "(0 = --replicas).")
    p.add_argument("--max-replicas", type=int,
                   default=_env_int("G2V_CHAOS_MAX_REPLICAS", 0),
                   help="Elastic ceiling forwarded to the router "
                        "(0 = static fleet of --replicas).")
    p.add_argument("--warm-spares", type=int,
                   default=_env_int("G2V_CHAOS_WARM", 0),
                   help="Pre-launched ringless spares kept warm by the "
                        "router for instant scale-up.")
    p.add_argument("--scale-interval", type=float,
                   default=_env_float("G2V_CHAOS_SCALE_INTERVAL", 0.5),
                   help="Router scaling-controller tick seconds.")
    p.add_argument("--shed", action="store_true",
                   default=_env_int("G2V_CHAOS_SHED", 0) > 0,
                   help="Forward --shed to the replicas: deadline-aware "
                        "admission shedding with structured retry_after_s.")
    p.add_argument("--tenant-quotas", type=str,
                   default=os.environ.get("G2V_CHAOS_QUOTAS"),
                   help="Forward --tenant-quotas SPEC to the replicas "
                        "(token-bucket rates + weighted-fair shares).")
    p.add_argument("--partition", action="store_true",
                   default=_env_int("G2V_CHAOS_PARTITION", 0) > 0,
                   help="Partition mode: the control-plane drill. The "
                        "harness launches the replicas itself (remote-"
                        "replicas router mode) with a TCP relay in front "
                        "of r0 that can blackhole either direction "
                        "independently, plus an HA router pair "
                        "(--lease-ttl-s + --standby). Drill phases: "
                        "false-dead fence + self-quarantine of a merely "
                        "partitioned replica; SIGSTOP the active router "
                        "past its ttl and prove every zombie mutating "
                        "command dies with structured stale_epoch; then "
                        "a chain of --takeovers router SIGKILLs with "
                        "degraded-mode client drills inside each gap.")
    p.add_argument("--takeovers", type=int,
                   default=_env_int("G2V_CHAOS_TAKEOVERS", 3),
                   help="Partition mode: SIGKILL-the-active-router "
                        "rounds after the zombie drill (a fresh standby "
                        "is spawned before each).")
    p.add_argument("--lease-ttl", type=float,
                   default=_env_float("G2V_CHAOS_LEASE_TTL", 1.5),
                   help="Partition mode: leadership lease ttl handed to "
                        "the routers (--lease-ttl-s). Small keeps the "
                        "takeover gaps short; the drill's clients must "
                        "ride them out regardless.")
    return p


class Soak:
    def __init__(self, opts, workdir: str):
        self.opts = opts
        self.wd = workdir
        self.rng = random.Random(opts.seed)
        self.sock = os.path.join(workdir, "chaos.sock")
        self.state = os.path.join(workdir, "state")
        self.metrics_path = os.path.join(workdir, "metrics.jsonl")
        self.log_path = os.path.join(workdir, "daemon.log")
        self.proc: Optional[subprocess.Popen] = None
        self.env = {**os.environ,
                    "PYTHONPATH": REPO + os.pathsep
                    + os.environ.get("PYTHONPATH", "")}
        self.lock = threading.Lock()
        self.acks: Dict[str, dict] = {}      # job_id -> {"k", "job"}
        self.rejected: List[int] = []
        self.unsubmitted: List[int] = []
        self.recoveries: List[float] = []
        self.kills = 0
        self.drains = 0
        self.drain_rcs: List[int] = []
        self.fault_injections: List[str] = []
        self.cancels_sent = 0
        self.notes: List[str] = []
        self._fault_serial = 0
        self.t0 = time.time()

    def note(self, msg: str) -> None:
        line = f"[{time.time() - self.t0:7.1f}s] {msg}"
        self.notes.append(line)
        print(f"# {line}", file=sys.stderr, flush=True)

    # ---- daemon lifecycle ------------------------------------------------

    def launch(self, fault_plan: Optional[str] = None) -> None:
        from g2vec_tpu_torch.serve import client

        env = dict(self.env)
        if fault_plan:
            self._fault_serial += 1
            env["G2VEC_FAULT_STATE"] = os.path.join(
                self.wd, f"fault-state-{self._fault_serial}.json")
        argv = [sys.executable, "-m", "g2vec_tpu_torch", "serve",
                "--socket", self.sock, "--state-dir", self.state,
                "--device", self.opts.device,
                "--cache-dir", os.path.join(self.wd, "cache"),
                "--queue-depth", "64", "--max-join", "6",
                "--metrics-jsonl", self.metrics_path]
        if fault_plan:
            argv += ["--fault-plan", fault_plan]
        log = open(self.log_path, "a")
        self.proc = subprocess.Popen(argv, env=env, stdout=log,
                                     stderr=subprocess.STDOUT)
        log.close()
        if not client.wait_ready(self.sock, 120):
            raise RuntimeError(
                f"daemon never became ready (log: {self.log_path})")

    def relaunch_after_death(self, why: str) -> None:
        t_down = time.time()
        self.launch()
        self.recoveries.append(time.time() - t_down)
        self.note(f"relaunched after {why} "
                  f"(ready in {self.recoveries[-1]:.1f}s)")

    # ---- job construction ------------------------------------------------

    def make_job(self, k: int, paths: dict, native_ok: bool) -> dict:
        rng = random.Random((self.opts.seed << 16) ^ k)
        job = dict(
            expression_file=paths["expression"],
            clinical_file=paths["clinical"],
            network_file=paths["network"],
            result_name=os.path.join(self.wd, "out", f"job{k}"),
            lenPath=8, numRepetition=2, sizeHiddenlayer=16,
            epoch=self.opts.epochs + rng.choice((0, 2, 4)),
            learningRate=0.05, numBiomarker=5, compute_dtype="float32",
            seed=0, train_seed=k, kmeans_seed=k)
        if native_ok and rng.random() < self.opts.stream_frac:
            job.update(train_mode="streaming", walker_backend="native",
                       shard_paths=16, checkpoint_every=1)
        else:
            job["walker_backend"] = "device"
        return job

    def submit_one(self, k: int, job: dict) -> None:
        """Submit until acknowledged (or rejected); backoff with jitter
        across daemon deaths. Terminal accounting happens from durable
        records, not from this stream."""
        from g2vec_tpu_torch.serve import client

        rng = random.Random((self.opts.seed << 20) ^ k)
        priority = "interactive" if rng.random() < 0.3 else "batch"
        deadline_s = (round(rng.uniform(2.0, 8.0), 2)
                      if rng.random() < 0.15 else None)
        for attempt in range(12):
            try:
                evs = client.submit_job(
                    self.sock, job, tenant=f"t{k % 3}", timeout=600,
                    priority=priority, deadline_s=deadline_s)
                if evs and evs[-1].get("event") == "rejected":
                    with self.lock:
                        self.rejected.append(k)
                    return
                jid = evs[0].get("job_id") if evs else None
                if jid:
                    with self.lock:
                        self.acks[jid] = {"k": k, "job": job,
                                          "deadline_s": deadline_s}
                    return
                break
            except client.ServeConnectionLost as e:
                if e.job_id:     # acknowledged; journaled; never resubmit
                    with self.lock:
                        self.acks[e.job_id] = {"k": k, "job": job,
                                               "deadline_s": deadline_s}
                    return
            except (client.ServeTimeout, OSError):
                pass
            time.sleep(min(5.0, 0.2 * (2 ** attempt))
                       + rng.uniform(0.0, 0.25))
        with self.lock:
            self.unsubmitted.append(k)

    # ---- chaos ops -------------------------------------------------------

    def op_sigkill(self) -> None:
        self.kills += 1
        self.note(f"chaos: SIGKILL daemon (kill #{self.kills})")
        try:
            os.kill(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait()
        self.relaunch_after_death("SIGKILL")

    def op_drain(self, relaunch_plan: Optional[str] = None) -> None:
        self.drains += 1
        self.note(f"chaos: SIGTERM drain (drain #{self.drains}"
                  + (f", relaunch armed: {relaunch_plan}"
                     if relaunch_plan else "") + ")")
        try:
            os.kill(self.proc.pid, signal.SIGTERM)
        except OSError:
            pass
        try:
            rc = self.proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = -9
        self.drain_rcs.append(rc)
        t_down = time.time()
        self.launch(fault_plan=relaunch_plan)
        self.recoveries.append(time.time() - t_down)
        if relaunch_plan:
            self.fault_injections.append(relaunch_plan)

    def op_cancel(self) -> None:
        from g2vec_tpu_torch.serve import client

        with self.lock:
            pending = [jid for jid in self.acks
                       if not os.path.exists(os.path.join(
                           self.state, "results", f"{jid}.json"))]
        if not pending:
            return
        jid = self.rng.choice(pending)
        self.cancels_sent += 1
        self.note(f"chaos: cancel {jid}")
        try:
            client.cancel(self.sock, jid)
        except (OSError, client.ServeConnectionLost):
            pass

    def run_chaos_op(self, op: str) -> None:
        if op == "sigkill":
            self.op_sigkill()
        elif op == "drain":
            self.op_drain()
        elif op == "fault_stream_ckpt":
            self.op_drain("stage=stream_ckpt,kind=sigkill")
        elif op == "fault_train":
            self.op_drain("stage=train,kind=sigkill")
        elif op == "fault_drain_seam":
            # Arm a crash INSIDE _begin_drain, then drain: the drain
            # thread dies at the seam but admission is already closed
            # and the stop flag still falls — the exit must stay clean.
            self.op_drain("stage=drain,kind=crash")
            self.op_drain()
        elif op == "cancel":
            self.op_cancel()

    # ---- accounting ------------------------------------------------------

    def results(self) -> Dict[str, dict]:
        out = {}
        rdir = os.path.join(self.state, "results")
        if not os.path.isdir(rdir):
            return out
        for fn in os.listdir(rdir):
            if fn.endswith(".json"):
                try:
                    with open(os.path.join(rdir, fn)) as f:
                        out[fn[:-5]] = json.load(f)
                except (OSError, ValueError):
                    pass
        return out

    def journal_ids(self) -> List[str]:
        jdir = os.path.join(self.state, "jobs")
        if not os.path.isdir(jdir):
            return []
        return [fn[:-5] for fn in os.listdir(jdir)
                if fn.endswith(".json")]

    def terminal_event_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        try:
            with open(self.metrics_path) as f:
                for line in f:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if ev.get("event") == "job_state" \
                            and ev.get("state") in TERMINAL_STATES:
                        jid = ev.get("job_id")
                        counts[jid] = counts.get(jid, 0) + 1
        except OSError:
            pass
        return counts


class RouterSoak(Soak):
    """Soak state for router mode: one router subprocess fronting N
    replica daemons it launches itself. The harness only ever kills
    things — every heal (replica relaunch, journal migration, adoption
    after a router restart) must come from the router, or the
    accounting fails."""

    def __init__(self, opts, workdir: str):
        super().__init__(opts, workdir)
        self.fleet = os.path.join(workdir, "fleet")
        self.router_metrics = os.path.join(workdir, "router-metrics.jsonl")
        self.router_log = os.path.join(workdir, "router.log")
        self.addr: Optional[str] = None
        self.router_restarts = 0
        self.replica_kills = 0
        self.replica_drains = 0

    # ---- router lifecycle -------------------------------------------

    def _router_argv(self) -> List[str]:
        return [sys.executable, "-m", "g2vec_tpu_torch", "serve",
                "--replicas", str(self.opts.replicas),
                "--listen", "127.0.0.1:0",
                "--state-dir", self.fleet,
                "--device", self.opts.device,
                "--cache-dir", os.path.join(self.wd, "cache"),
                "--queue-depth", "64", "--max-join", "6",
                "--probe-interval", "0.4", "--probe-deadline", "3.0",
                "--metrics-jsonl", self.router_metrics]

    def launch_router(self) -> None:
        argv = self._router_argv()
        addr_file = os.path.join(self.fleet, "router_addr")
        try:
            os.unlink(addr_file)
        except OSError:
            pass
        log = open(self.router_log, "a")
        self.proc = subprocess.Popen(argv, env=self.env, stdout=log,
                                     stderr=subprocess.STDOUT)
        log.close()
        deadline = time.time() + 600
        while time.time() < deadline:
            if os.path.exists(addr_file):
                with open(addr_file) as f:
                    self.addr = f.read().strip()
                if self.addr:
                    return
            if self.proc.poll() is not None:
                raise RuntimeError(f"router died during boot "
                                   f"(rc={self.proc.returncode}; log: "
                                   f"{self.router_log})")
            time.sleep(0.2)
        raise RuntimeError(f"router never bound (log: {self.router_log})")

    def router_status(self) -> Optional[dict]:
        from g2vec_tpu_torch.serve import client, protocol

        try:
            return client.status(self.addr, timeout=10.0)
        except (OSError, client.ServeConnectionLost,
                protocol.ProtocolError):
            return None

    # ---- fleet-wide accounting --------------------------------------

    def _replica_dirs(self) -> List[str]:
        return [os.path.join(self.fleet, f"r{i}")
                for i in range(self.opts.replicas)]

    def results(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for rdir in self._replica_dirs():
            resd = os.path.join(rdir, "state", "results")
            if not os.path.isdir(resd):
                continue
            for fn in os.listdir(resd):
                if fn.endswith(".json"):
                    try:
                        with open(os.path.join(resd, fn)) as f:
                            out[fn[:-5]] = json.load(f)
                    except (OSError, ValueError):
                        pass
        return out

    def result_locations(self) -> Dict[str, List[str]]:
        """job_id -> replica names holding a result record. More than
        one means a job ran (terminally) on two replicas — a duplicate
        the terminal-event count alone could miss."""
        locs: Dict[str, List[str]] = {}
        for i, rdir in enumerate(self._replica_dirs()):
            resd = os.path.join(rdir, "state", "results")
            if not os.path.isdir(resd):
                continue
            for fn in os.listdir(resd):
                if fn.endswith(".json"):
                    locs.setdefault(fn[:-5], []).append(f"r{i}")
        return locs

    def journal_ids(self) -> List[str]:
        out = []
        for rdir in self._replica_dirs():
            jdir = os.path.join(rdir, "state", "jobs")
            if os.path.isdir(jdir):
                out += [fn[:-5] for fn in os.listdir(jdir)
                        if fn.endswith(".json")]
        return out

    def terminal_event_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for rdir in self._replica_dirs():
            path = os.path.join(rdir, "metrics.jsonl")
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        if ev.get("event") == "job_state" \
                                and ev.get("state") in TERMINAL_STATES:
                            jid = ev.get("job_id")
                            counts[jid] = counts.get(jid, 0) + 1
            except OSError:
                pass
        return counts

    def failover_events(self) -> List[dict]:
        out = []
        try:
            with open(self.router_metrics) as f:
                for line in f:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if ev.get("event") == "failover":
                        out.append(ev)
        except OSError:
            pass
        return out

    # ---- chaos ops ---------------------------------------------------

    def _pick_replica(self) -> Optional[str]:
        st = self.router_status()
        if not st:
            return None
        reps = st.get("replicas") or {}
        live = [n for n, r in reps.items()
                if r.get("state") in ("healthy", "suspect")
                and r.get("pid")]
        if not live:
            return None
        name = self.rng.choice(sorted(live))
        self._victim_pid = reps[name].get("pid")
        return name

    def op_replica_sigkill(self) -> None:
        name = self._pick_replica()
        if name is None:
            self.note("chaos: replica SIGKILL skipped (none healthy)")
            return
        self.replica_kills += 1
        self.note(f"chaos: SIGKILL replica {name} "
                  f"(pid {self._victim_pid}, kill "
                  f"#{self.replica_kills})")
        try:
            os.kill(self._victim_pid, signal.SIGKILL)
        except OSError:
            pass
        # NO relaunch here: detection, fencing, journal migration, and
        # the relaunch are all the router's job.

    def op_replica_drain(self) -> None:
        from g2vec_tpu_torch.serve import client

        name = self._pick_replica()
        if name is None:
            self.note("chaos: replica drain skipped (none healthy)")
            return
        self.replica_drains += 1
        self.note(f"chaos: drain replica {name} "
                  f"(drain #{self.replica_drains})")
        try:
            for ev in client.request(self.addr,
                                     {"op": "drain_replica",
                                      "replica": name}, timeout=600.0):
                if ev.get("event") == "drained":
                    self.drain_rcs.append(ev.get("rc", -1))
                break
        except (OSError, client.ServeConnectionLost):
            self.note(f"drain of {name} lost its stream (router died?)")

    def op_router_restart(self) -> None:
        self.router_restarts += 1
        self.note(f"chaos: SIGKILL router + restart "
                  f"(#{self.router_restarts}) — replicas orphaned, "
                  f"must be adopted")
        try:
            os.kill(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait()
        t_down = time.time()
        self.launch_router()
        self.recoveries.append(time.time() - t_down)

    def op_cancel_routed(self) -> None:
        from g2vec_tpu_torch.serve import client

        results = self.results()
        with self.lock:
            pending = [jid for jid in self.acks if jid not in results]
        if not pending:
            return
        jid = self.rng.choice(sorted(pending))
        self.cancels_sent += 1
        self.note(f"chaos: cancel {jid} (via router broadcast)")
        try:
            client.cancel(self.addr, jid, timeout=30.0)
        except (OSError, client.ServeConnectionLost):
            pass

    def run_chaos_op(self, op: str) -> None:
        if op == "replica_sigkill":
            self.op_replica_sigkill()
        elif op == "replica_drain":
            self.op_replica_drain()
        elif op == "router_restart":
            self.op_router_restart()
        elif op == "cancel":
            self.op_cancel_routed()

    # ---- submission --------------------------------------------------

    def submit_one(self, k: int, job: dict) -> None:
        """Submit through the router until acked. Unlike the classic
        soak, EVERY attempt carries the same deterministic idem key, so
        resubmitting after a lost ack is safe — the fleet acks the
        original job exactly once (deduped=True on the repeat)."""
        from g2vec_tpu_torch.serve import client

        rng = random.Random((self.opts.seed << 20) ^ k)
        priority = "interactive" if rng.random() < 0.3 else "batch"
        deadline_s = (round(rng.uniform(2.0, 8.0), 2)
                      if rng.random() < 0.15 else None)
        idem = f"soak-{self.opts.seed}-{k}"
        for attempt in range(14):
            try:
                evs = client.submit_job(
                    self.addr, job, tenant=f"t{k % 3}", timeout=600,
                    priority=priority, deadline_s=deadline_s,
                    idem_key=idem)
                if evs and evs[-1].get("event") == "rejected":
                    # Transient fleet states — retry with the SAME idem
                    # key (safe by construction): the router had no
                    # eligible replica yet, or the ring target was
                    # caught mid-drain.
                    if evs[-1].get("error") in ("no_replicas",
                                                "draining"):
                        raise OSError(f"fleet busy: {evs[-1]['error']}")
                    with self.lock:
                        self.rejected.append(k)
                    return
                jid = evs[0].get("job_id") if evs else None
                if jid:
                    with self.lock:
                        self.acks[jid] = {"k": k, "job": job,
                                          "deadline_s": deadline_s}
                    return
                break
            except client.ServeConnectionLost as e:
                if e.job_id:
                    with self.lock:
                        self.acks[e.job_id] = {"k": k, "job": job,
                                               "deadline_s": deadline_s}
                    return
            except (client.ServeTimeout, OSError):
                pass
            time.sleep(min(5.0, 0.2 * (2 ** attempt))
                       + rng.uniform(0.0, 0.25))
        with self.lock:
            self.unsubmitted.append(k)


#: SLO classes for autoscale mode: arrival share, probability a job
#: carries a deadline, the deadline range (queue-wait budget, seconds),
#: and how often the tenant submits at interactive priority. Gold is
#: latency-critical (every job deadlined), bulk is throughput traffic
#: that can wait.
TENANT_CLASSES = {
    "gold":   {"share": 0.30, "deadline_p": 1.0, "deadline": (5.0, 8.0),
               "interactive_p": 0.8},
    "silver": {"share": 0.30, "deadline_p": 0.5, "deadline": (7.0, 11.0),
               "interactive_p": 0.3},
    "bulk":   {"share": 0.40, "deadline_p": 0.1, "deadline": (15.0, 25.0),
               "interactive_p": 0.0},
}

#: Default per-tenant token buckets + weighted-fair shares for the
#: elastic arm: gold paid for headroom and 3x queue weight, bulk gets a
#: tight bucket so a bulk flash-crowd defers to gold instead of
#: starving it.
DEFAULT_QUOTAS = "gold:6:12:3;silver:3:6:2;bulk:0.8:2:1"


def diurnal_arrivals(n: int, rng: random.Random, base_rate: float,
                     period_s: float,
                     spikes: List[Tuple[float, float, float]]) -> List[float]:
    """Seeded non-homogeneous arrival times: a sinusoid over
    ``base_rate`` (the diurnal curve, compressed to ``period_s``) with
    multiplicative flash-crowd windows ``(start_s, dur_s, mult)``. The
    same (seed, knobs) always yields the same schedule — that is what
    makes the static/elastic A/B a controlled experiment."""
    arrivals, t = [], 0.0
    for _ in range(n):
        rate = base_rate * (1.0 + 0.5 * math.sin(2 * math.pi * t / period_s))
        for (s0, dur, mult) in spikes:
            if s0 <= t < s0 + dur:
                rate *= mult
        arrivals.append(t)
        t += rng.expovariate(max(0.05, rate))
    return arrivals


class AutoscaleSoak(RouterSoak):
    """Soak state for autoscale mode: the router fronts a fleet that is
    either elastic (min..max active replicas, warm spares, deadline
    shedding, tenant quotas) or static (the baseline arm), and the load
    is the seeded diurnal/burst model with tenant SLO classes. The
    submit loop is SLO-aware: structured ``shed`` / ``tenant_quota``
    rejections are retried with the SAME idempotency key after the
    advised ``retry_after_s`` (plus jitter), for a bounded number of
    attempts; exhaustion is recorded per tenant as a final shed — never
    as a lost job, because a shed job was refused BEFORE journaling."""

    MAX_SHED_RETRIES = 8

    def __init__(self, opts, workdir: str):
        super().__init__(opts, workdir)
        self.gave_up: List[dict] = []        # exhausted shed/quota retries
        self.shed_retries = 0                # shed rejections retried
        self.quota_retries = 0               # quota rejections retried
        self.status_checks = 0
        self.status_violations: List[str] = []
        self.max_active_seen = 0
        self.arrival_t0: Optional[float] = None
        self.warmup_job: Optional[str] = None  # canary file for spares

    # ---- fleet shape -------------------------------------------------

    def _elastic(self) -> bool:
        mn = self.opts.min_replicas or self.opts.replicas
        mx = self.opts.max_replicas or self.opts.replicas
        return mx > mn

    def _fleet_width(self) -> int:
        return (max(self.opts.replicas, self.opts.max_replicas)
                + max(0, self.opts.warm_spares))

    def _replica_dirs(self) -> List[str]:
        return [os.path.join(self.fleet, f"r{i}")
                for i in range(self._fleet_width())]

    def journal_ids(self) -> List[str]:
        """Leftover journal entries, excluding warm-pool canaries: the
        shutdown can land while a spare's ``--warmup-job`` is queued,
        and an abandoned canary is not lost work — its result is
        discarded by design (the warmth was the product), and it never
        appears in the ack ledger this accounting audits."""
        out = []
        for rdir in self._replica_dirs():
            jdir = os.path.join(rdir, "state", "jobs")
            if not os.path.isdir(jdir):
                continue
            for fn in os.listdir(jdir):
                if not fn.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(jdir, fn)) as f:
                        if json.load(f).get("tenant") == "_warmup":
                            continue
                except (OSError, ValueError):
                    pass
                out.append(fn[:-5])
        return out

    def _router_argv(self) -> List[str]:
        argv = super()._router_argv()
        if self.opts.max_replicas:
            argv += ["--min-replicas", str(self.opts.min_replicas),
                     "--max-replicas", str(self.opts.max_replicas),
                     "--warm-spares", str(self.opts.warm_spares),
                     "--scale-interval", str(self.opts.scale_interval)]
            if self.warmup_job:
                argv += ["--warmup-job", self.warmup_job]
        if self.opts.shed:
            argv += ["--shed"]
        if self.opts.tenant_quotas:
            argv += ["--tenant-quotas", self.opts.tenant_quotas]
        return argv

    # ---- SLO assignment ----------------------------------------------

    def slo_of(self, k: int) -> Tuple[str, Optional[float], str]:
        """Deterministic (seed, k) -> (tenant, deadline_s, priority).
        Independent of arm shape, so the static and elastic runs submit
        byte-identical SLO mixes."""
        rng = random.Random((self.opts.seed << 24) ^ k)
        r, acc = rng.random(), 0.0
        tenant = "bulk"
        for name, cls in TENANT_CLASSES.items():
            acc += cls["share"]
            if r < acc:
                tenant = name
                break
        cls = TENANT_CLASSES[tenant]
        deadline_s = (round(rng.uniform(*cls["deadline"]), 2)
                      if rng.random() < cls["deadline_p"] else None)
        priority = ("interactive"
                    if rng.random() < cls["interactive_p"] else "batch")
        return tenant, deadline_s, priority

    def make_job(self, k: int, paths: dict, native_ok: bool) -> dict:
        """Tenant-shaped job mix with DISTINCT batch-join keys. The
        base soak submits config-identical jobs, which the daemon joins
        into one amortized batch — a load so compressible that a single
        replica absorbs any spike, and the ring (which places by join
        key) sends every job to ONE owner. Real multi-tenant traffic is
        the opposite. Gold/silver are interactive: small jobs on cached
        engine shapes (one lane bucket). Bulk is batch analytics: each
        job wants its own walk length and model width, so nearly every
        bulk job is a bucket of its own on the daemon's single
        scheduler. That cost asymmetry is what the flash crowd
        weaponizes: a wall of bulk batches lands in front of deadlined
        gold traffic."""
        job = super().make_job(k, paths, native_ok)
        job["numBiomarker"] = 2 + (k % 25)
        tenant, _, _ = self.slo_of(k)
        if tenant == "bulk":
            job["lenPath"] = 10 + 2 * (k % 16)
            job["sizeHiddenlayer"] = 24
        else:
            job["lenPath"] = 8
        job["numRepetition"] = 3
        return job

    # ---- chaos: kill an ACTIVE replica only --------------------------

    def _pick_replica(self) -> Optional[str]:
        st = self.router_status()
        if not st:
            return None
        reps = st.get("replicas") or {}
        live = [n for n, r in reps.items()
                if r.get("state") in ("healthy", "suspect")
                and r.get("pid") and r.get("role") == "active"]
        if not live:
            return None
        name = self.rng.choice(sorted(live))
        self._victim_pid = reps[name].get("pid")
        return name

    # ---- aggregate-status assertions ---------------------------------

    def check_router_status(self) -> None:
        """One assertion pass over the router's fleet-wide /status: the
        keys the dashboard (and this accounting) depend on must exist
        and the scale state must respect the configured bounds. Any
        violation fails the soak."""
        st = self.router_status()
        if not st:
            return                 # router mid-restart: not a violation
        self.status_checks += 1
        probs: List[str] = []
        for key in ("replicas", "active", "warm_pool", "warm_pool_size",
                    "autoscale", "last_scale_event", "scale_ups",
                    "scale_downs", "fleet"):
            if key not in st:
                probs.append(f"missing key {key!r}")
        auto = st.get("autoscale") or {}
        active = st.get("active") or []
        self.max_active_seen = max(self.max_active_seen, len(active))
        mn = self.opts.min_replicas or self.opts.replicas
        mx = self.opts.max_replicas or self.opts.replicas
        if bool(auto.get("elastic")) != self._elastic():
            probs.append(f"autoscale.elastic={auto.get('elastic')!r}, "
                         f"expected {self._elastic()}")
        if active and not (1 <= len(active) <= mx):
            probs.append(f"active={len(active)} outside [1, {mx}]")
        # Transient overfill is legal (a demote parks its replica even
        # when the pool is full) but bounded by the fleet width.
        warm_cap = mx + max(0, self.opts.warm_spares) - mn
        if st.get("warm_pool_size", 0) > warm_cap:
            probs.append(f"warm_pool_size={st.get('warm_pool_size')} "
                         f"exceeds bound {warm_cap}")
        if st.get("scale_ups", 0) > 0:
            ev = st.get("last_scale_event") or {}
            for field in ("kind", "replica", "at"):
                if field not in ev:
                    probs.append(f"last_scale_event missing {field!r}")
        fleet = st.get("fleet") or {}
        if fleet:
            for key in ("queued", "running", "est_wait_s", "tenants"):
                if key not in fleet:
                    probs.append(f"fleet aggregate missing {key!r}")
        for p in probs:
            if p not in self.status_violations:
                self.status_violations.append(p)
                self.note(f"STATUS VIOLATION: {p}")

    # ---- router metrics ----------------------------------------------

    def router_events(self, kinds: Tuple[str, ...]) -> List[dict]:
        out = []
        try:
            with open(self.router_metrics) as f:
                for line in f:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if ev.get("event") in kinds:
                        out.append(ev)
        except OSError:
            pass
        return out

    def slo_events(self) -> Dict[str, int]:
        """Fleet-wide admission-SLO event counts from every replica's
        durable metrics stream (the in-memory per-tenant ledgers die
        with a SIGKILLed replica; the JSONL does not)."""
        counts = {"shed": 0, "tenant_quota": 0}
        for rdir in self._replica_dirs():
            path = os.path.join(rdir, "metrics.jsonl")
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        if ev.get("event") in counts:
                            counts[ev.get("event")] += 1
            except OSError:
                pass
        return counts

    # ---- SLO-aware submission ----------------------------------------

    def submit_one(self, k: int, job: dict) -> None:
        from g2vec_tpu_torch.serve import client

        rng = random.Random((self.opts.seed << 20) ^ k)
        tenant, deadline_s, priority = self.slo_of(k)
        idem = f"soak-{self.opts.seed}-{k}"
        sheds = 0
        for attempt in range(16):
            try:
                evs = client.submit_job(
                    self.addr, job, tenant=tenant, timeout=600,
                    priority=priority, deadline_s=deadline_s,
                    idem_key=idem)
                if evs and evs[-1].get("event") == "rejected":
                    err = evs[-1].get("error")
                    if err in ("no_replicas", "draining", "queue_full"):
                        raise OSError(f"fleet busy: {err}")
                    if err in ("shed", "tenant_quota"):
                        sheds += 1
                        with self.lock:
                            if err == "shed":
                                self.shed_retries += 1
                            else:
                                self.quota_retries += 1
                        if sheds > self.MAX_SHED_RETRIES:
                            with self.lock:
                                self.gave_up.append(
                                    {"k": k, "tenant": tenant,
                                     "deadline_s": deadline_s,
                                     "error": err})
                            return
                        ra = evs[-1].get("retry_after_s")
                        ra = float(ra) if isinstance(ra, (int, float)) \
                            else 0.5
                        time.sleep(min(8.0, max(0.05, ra))
                                   + rng.uniform(0.0, 0.3))
                        continue
                    with self.lock:
                        self.rejected.append(k)
                    return
                jid = evs[0].get("job_id") if evs else None
                if jid:
                    with self.lock:
                        self.acks[jid] = {"k": k, "job": job,
                                          "deadline_s": deadline_s,
                                          "tenant": tenant}
                    return
                break
            except client.ServeConnectionLost as e:
                if e.job_id:
                    with self.lock:
                        self.acks[e.job_id] = {"k": k, "job": job,
                                               "deadline_s": deadline_s,
                                               "tenant": tenant}
                    return
            except (client.ServeTimeout, OSError):
                pass
            time.sleep(min(5.0, 0.2 * (2 ** attempt))
                       + rng.uniform(0.0, 0.25))
        with self.lock:
            self.unsubmitted.append(k)


def run_router_soak(opts, workdir: str) -> dict:
    """The replicated-fleet storm: N replicas behind the router, seeded
    replica-SIGKILL / replica-drain / router-restart rotation, fleet-wide
    exactly-once accounting, byte parity vs solo twins, and the
    death-to-first-requeue latency distribution from the router's
    ``failover`` events."""
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.serve import client

    soak = RouterSoak(opts, workdir)
    native_ok = bool(shutil.which("g++")) and opts.stream_frac > 0
    spec = SyntheticSpec(n_good=24, n_poor=20, module_size=12,
                         n_background=24, n_expr_only=4, n_net_only=4,
                         module_chords=2, background_edges=40, seed=7)
    paths = write_synthetic_tsv(spec, os.path.join(workdir, "data"))
    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)

    n = opts.jobs
    n_ops = opts.chaos_ops or max(3, n // 8)
    rng = soak.rng
    arrivals, t = [], 0.0
    for _ in range(n):
        arrivals.append(t)
        t += rng.expovariate(1.0 / opts.mean_arrival)
    op_pool = ["replica_sigkill", "replica_drain", "router_restart",
               "cancel", "replica_sigkill"]
    ops = [op_pool[i % len(op_pool)] for i in range(n_ops)]
    rng.shuffle(ops)

    soak.note(f"router soak: {n} jobs over {opts.replicas} replicas "
              f"(stream_frac={opts.stream_frac if native_ok else 0}), "
              f"{n_ops} chaos ops {ops}, seed {opts.seed}")
    soak.launch_router()

    threads: List[threading.Thread] = []

    def arrival_loop():
        t0 = time.time()
        jobs = [soak.make_job(k, paths, native_ok) for k in range(n)]
        for k in range(n):
            now = time.time() - t0
            if now < arrivals[k]:
                time.sleep(arrivals[k] - now)
            th = threading.Thread(target=soak.submit_one,
                                  args=(k, jobs[k]), daemon=True)
            th.start()
            threads.append(th)

    arr = threading.Thread(target=arrival_loop, daemon=True)
    arr.start()

    deadline = soak.t0 + opts.budget_s
    next_chaos = time.time() + rng.uniform(1.0, opts.chaos_every)
    budget_blown = False
    while True:
        if time.time() > deadline:
            budget_blown = True
            soak.note("BUDGET BLOWN — abandoning the storm")
            break
        if soak.proc.poll() is not None:
            # The router must never die except when we kill it.
            soak.note(f"router self-death rc={soak.proc.returncode} — "
                      f"restarting (counts against it)")
            soak.launch_router()
        if ops and time.time() >= next_chaos:
            soak.run_chaos_op(ops.pop(0))
            next_chaos = time.time() + rng.uniform(
                0.5 * opts.chaos_every, 1.5 * opts.chaos_every)
        if not ops and not arr.is_alive() \
                and all(not th.is_alive() for th in threads):
            with soak.lock:
                acked = set(soak.acks)
            if acked and acked <= set(soak.results()) \
                    and not soak.journal_ids():
                break
        time.sleep(0.25)

    arr.join(timeout=60)
    for th in threads:
        th.join(timeout=120)
    while not budget_blown and time.time() < deadline:
        if soak.proc.poll() is not None:
            soak.launch_router()
        with soak.lock:
            acked = set(soak.acks)
        if acked <= set(soak.results()) and not soak.journal_ids():
            break
        time.sleep(0.5)
    try:
        client.shutdown(soak.addr)
        soak.proc.wait(timeout=180)
    except (OSError, client.ServeConnectionLost,
            subprocess.TimeoutExpired):
        soak.proc.kill()
        soak.proc.wait()

    # ---- accounting --------------------------------------------------
    results = soak.results()
    locations = soak.result_locations()
    with soak.lock:
        acks = dict(soak.acks)
    lost = sorted(jid for jid in acks if jid not in results)
    term_counts = soak.terminal_event_counts()
    duplicated = sorted(set(
        [jid for jid, c in term_counts.items() if c > 1]
        + [jid for jid, where in locations.items() if len(where) > 1]))
    by_status: Dict[str, int] = {}
    for jid in acks:
        st = results.get(jid, {}).get("status", "LOST")
        by_status[st] = by_status.get(st, 0) + 1

    failovers = soak.failover_events()
    requeue_lat = [ev.get("latency_s", 0.0) for ev in failovers]

    byte_checked, byte_identical, mismatches = _byte_parity(
        soak, acks, results, workdir, opts.verify)

    ok = (not budget_blown and not lost and not duplicated
          and not soak.unsubmitted and not soak.journal_ids()
          and by_status.get("failed", 0) == 0
          and byte_identical == byte_checked
          # rc None = the drained replica was ADOPTED (router restarted
          # mid-soak; not our child, so no exit code is collectible) —
          # the drain itself still completed synchronously.
          and all(rc in (0, None) for rc in soak.drain_rcs))
    return {
        "ok": ok, "mode": "router", "seed": opts.seed, "jobs": n,
        "replicas": opts.replicas,
        "accepted": len(acks), "rejected": len(soak.rejected),
        "unsubmitted": len(soak.unsubmitted),
        "terminal_by_status": by_status,
        "lost": lost, "duplicated": duplicated,
        "journal_leftover": soak.journal_ids(),
        "replica_kills": soak.replica_kills,
        "replica_drains": soak.replica_drains,
        "router_restarts": soak.router_restarts,
        "drain_exit_codes": soak.drain_rcs,
        "cancels_sent": soak.cancels_sent,
        "failovers": len(failovers),
        "requeue_p50_s": _percentile(requeue_lat, 0.5),
        "requeue_p99_s": _percentile(requeue_lat, 0.99),
        "router_restart_p99_s": _percentile(soak.recoveries, 0.99),
        "byte_checked": byte_checked, "byte_identical": byte_identical,
        "mismatches": mismatches,
        "budget_blown": budget_blown,
        "wall_s": round(time.time() - soak.t0, 1),
    }


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return round(s[min(len(s) - 1, int(round(q * (len(s) - 1))))], 3)


def _byte_parity(soak, acks: Dict[str, dict], results: Dict[str, dict],
                 workdir: str, n_verify: int):
    """Re-run a sample of completed jobs solo and uninterrupted in THIS
    process; their outputs must be byte-identical to what the stormed
    fleet recorded. Returns (checked, identical, mismatches)."""
    done_ids = [jid for jid in acks
                if results.get(jid, {}).get("status") == "done"]
    sample = sorted(done_ids)[:max(0, n_verify)]
    byte_checked, byte_identical, mismatches = 0, 0, []
    if not sample:
        return byte_checked, byte_identical, mismatches
    from g2vec_tpu_torch.batch.engine import _variant_from_dict, lane_config
    from g2vec_tpu_torch.config import G2VecConfig, config_from_job
    from g2vec_tpu_torch.pipeline import run as solo_run

    for jid in sample:
        k = acks[jid]["k"]
        job = acks[jid]["job"]
        cfg = config_from_job(
            {**job, "result_name": os.path.join(workdir, "out",
                                                f"solo{k}")},
            G2VecConfig(device=soak.opts.device))
        v = _variant_from_dict(0, {"name": "v"}, cfg)
        sres = solo_run(lane_config(cfg, v), console=lambda s: None)
        outs = results[jid]["variants"]["v"]["outputs"]
        byte_checked += 1
        same = True
        for fa, fb in zip(sorted(outs), sorted(sres.output_files)):
            with open(fa, "rb") as a, open(fb, "rb") as b:
                if a.read() != b.read():
                    same = False
                    mismatches.append(f"{jid}: {fa} != {fb}")
        byte_identical += int(same)
        soak.note(f"parity {jid} (job{k}): "
                  f"{'identical' if same else 'MISMATCH'}")
    return byte_checked, byte_identical, mismatches


def run_autoscale_soak(opts, workdir: str) -> dict:
    """The elastic-vs-static proof harness: the seeded diurnal/burst
    storm with tenant SLO classes against ONE fleet shape (run it
    twice, static then elastic, for the identical schedule). One active
    replica is SIGKILLed mid-spike;
    every heal and every scale event must come from the router. The
    summary carries deadline deaths, per-tenant attainment, shed/quota
    traffic, goodput, and the scale-up reaction distribution on top of
    the fleet-wide exactly-once predicate."""
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.serve import client

    soak = AutoscaleSoak(opts, workdir)
    native_ok = bool(shutil.which("g++")) and opts.stream_frac > 0
    # Heavier cohort than the base soak: per-job cost must be real for
    # a flash crowd to build an actual queue (the tiny spec services in
    # ~0.3 s/job and no arrival rate this side of silly saturates it).
    spec = SyntheticSpec(n_good=44, n_poor=40, module_size=12,
                         n_background=44, n_expr_only=6, n_net_only=6,
                         module_chords=2, background_edges=80, seed=7)
    paths = write_synthetic_tsv(spec, os.path.join(workdir, "data"))
    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)

    # The warm-pool canary: a gold/silver-shaped job run on a spare
    # before it is ever promoted, so the first CUDA use, the kernels'
    # load and the dataset's parse are paid there and the deadlined
    # traffic lands on a hot process. Bulk's shapes stay cold by
    # design; bulk carries (almost) no deadlines to miss.
    if soak._elastic() and opts.warm_spares > 0:
        canary = soak.make_job(0, paths, native_ok)
        canary.update(lenPath=8, sizeHiddenlayer=16, numRepetition=3,
                      numBiomarker=2, epoch=opts.epochs,
                      result_name=os.path.join(workdir, "out", "warmup"))
        soak.warmup_job = os.path.join(workdir, "warmup_job.json")
        with open(soak.warmup_job, "w") as fh:
            json.dump(canary, fh)

    n = opts.jobs
    rng = soak.rng
    # The load model: one compressed "day" with two flash crowds. The
    # spike times are seed-jittered, then shared verbatim by both arms.
    spikes = [(rng.uniform(14.0, 17.0), 6.0, 12.0),
              (rng.uniform(52.0, 58.0), 8.0, 4.0)]
    arrivals = diurnal_arrivals(n, rng, base_rate=0.6, period_s=70.0,
                                spikes=spikes)
    # The acceptance kill: one ACTIVE replica dies 2.5 s into the first
    # flash crowd, when the queue is deepest and a lost journal would
    # hurt the most. By then the elastic arm has already scaled up
    # (the crowd trips the queue threshold within a tick or two), so a
    # survivor is in the ring to inherit the dead journal; the static
    # arm's queued jobs instead wait out the full fence+relaunch window
    # with their deadline clocks running.
    kill_at = spikes[0][0] + 2.5

    soak.note(f"autoscale soak ({'elastic' if soak._elastic() else 'static'}"
              f"): {n} jobs over base {opts.replicas} replica(s), "
              f"max={opts.max_replicas or opts.replicas} "
              f"warm={opts.warm_spares} shed={opts.shed} "
              f"quotas={'yes' if opts.tenant_quotas else 'no'}, "
              f"spikes={[(round(s, 1), d, m) for s, d, m in spikes]}, "
              f"kill_at={kill_at:.1f}s, seed {opts.seed}")
    soak.launch_router()

    if soak.warmup_job:
        # Bring-up discipline: the storm opens only after the initial
        # warm pool is WARM (canary complete). Operators finish
        # provisioning before opening the doors — and on a shared-CPU
        # host, a mid-storm canary run steals exactly the cycles
        # the active set needs to hold its deadlines. Bounded wait: a
        # failed warmup degrades to the old cold-spare behavior.
        warm_wait_t0 = time.time()
        while time.time() - warm_wait_t0 < 120.0:
            warmed = sum(1 for ev in soak.router_events(("warm_spare",))
                         if ev.get("outcome") == "warmed")
            if warmed >= opts.warm_spares:
                soak.note(f"warm pool warmed ({warmed} spare(s), "
                          f"{time.time() - warm_wait_t0:.1f}s) — "
                          f"opening the storm")
                break
            time.sleep(0.5)
        else:
            soak.note("warm pool never finished warming (120s) — "
                      "storm opens against cold spares")

    threads: List[threading.Thread] = []
    soak.arrival_t0 = time.time()

    def arrival_loop():
        t0 = soak.arrival_t0
        jobs = [soak.make_job(k, paths, native_ok) for k in range(n)]
        for k in range(n):
            now = time.time() - t0
            if now < arrivals[k]:
                time.sleep(arrivals[k] - now)
            th = threading.Thread(target=soak.submit_one,
                                  args=(k, jobs[k]), daemon=True)
            th.start()
            threads.append(th)

    arr = threading.Thread(target=arrival_loop, daemon=True)
    arr.start()

    deadline = soak.t0 + opts.budget_s
    kill_wall = soak.arrival_t0 + kill_at
    killed = False
    next_status = time.time() + 1.0
    budget_blown = False
    while True:
        if time.time() > deadline:
            budget_blown = True
            soak.note("BUDGET BLOWN — abandoning the storm")
            break
        if soak.proc.poll() is not None:
            soak.note(f"router self-death rc={soak.proc.returncode} — "
                      f"restarting (counts against it)")
            soak.launch_router()
        if not killed and time.time() >= kill_wall:
            killed = True
            soak.op_replica_sigkill()
        if time.time() >= next_status:
            soak.check_router_status()
            next_status = time.time() + 1.0
        if killed and not arr.is_alive() \
                and all(not th.is_alive() for th in threads):
            with soak.lock:
                acked = set(soak.acks)
            if acked and acked <= set(soak.results()) \
                    and not soak.journal_ids():
                break
        time.sleep(0.25)

    arr.join(timeout=60)
    for th in threads:
        th.join(timeout=120)
    while not budget_blown and time.time() < deadline:
        if soak.proc.poll() is not None:
            soak.launch_router()
        with soak.lock:
            acked = set(soak.acks)
        if acked <= set(soak.results()) and not soak.journal_ids():
            break
        time.sleep(0.5)
    soak.check_router_status()
    try:
        client.shutdown(soak.addr)
        soak.proc.wait(timeout=180)
    except (OSError, client.ServeConnectionLost,
            subprocess.TimeoutExpired):
        soak.proc.kill()
        soak.proc.wait()

    # ---- accounting --------------------------------------------------
    results = soak.results()
    locations = soak.result_locations()
    with soak.lock:
        acks = dict(soak.acks)
        gave_up = list(soak.gave_up)
    lost = sorted(jid for jid in acks if jid not in results)
    term_counts = soak.terminal_event_counts()
    duplicated = sorted(set(
        [jid for jid, c in term_counts.items() if c > 1]
        + [jid for jid, where in locations.items() if len(where) > 1]))
    by_status: Dict[str, int] = {}
    for jid in acks:
        st = results.get(jid, {}).get("status", "LOST")
        by_status[st] = by_status.get(st, 0) + 1
    deadline_deaths = by_status.get("deadline_exceeded", 0)

    # Per-tenant SLO attainment over DEADLINED traffic: done /
    # (deadlined acked + deadlined given-up-after-sheds). A finally-shed
    # job counts against the tenant — refusing it is still a miss, just
    # an honest, early, cheap one.
    attainment: Dict[str, Optional[float]] = {}
    att_num_total, att_den_total = 0, 0
    gave_up_by_tenant: Dict[str, int] = {}
    for g in gave_up:
        gave_up_by_tenant[g["tenant"]] = \
            gave_up_by_tenant.get(g["tenant"], 0) + 1
    for tenant in TENANT_CLASSES:
        acked_dl = [jid for jid, a in acks.items()
                    if a.get("tenant") == tenant
                    and a.get("deadline_s") is not None]
        num = sum(1 for jid in acked_dl
                  if results.get(jid, {}).get("status") == "done")
        den = len(acked_dl) + sum(1 for g in gave_up
                                  if g["tenant"] == tenant
                                  and g["deadline_s"] is not None)
        attainment[tenant] = round(num / den, 3) if den else None
        att_num_total += num
        att_den_total += den
    attainment_overall = (round(att_num_total / att_den_total, 3)
                          if att_den_total else None)

    # Scale evidence from the router's durable metrics stream.
    ups = soak.router_events(("scale_up",))
    downs = soak.router_events(("scale_down",))
    warm_evs = soak.router_events(("warm_spare",))
    warm_outcomes: Dict[str, int] = {}
    for ev in warm_evs:
        o = ev.get("outcome", "?")
        warm_outcomes[o] = warm_outcomes.get(o, 0) + 1
    reactions = [float(ev.get("reaction_s", 0.0)) for ev in ups]
    spike1_wall = soak.arrival_t0 + spikes[0][0]
    spike_to_scale = None
    for ev in ups:
        ts = ev.get("ts")
        if isinstance(ts, (int, float)) and ts >= spike1_wall:
            spike_to_scale = round(ts - spike1_wall, 2)
            break
    slo_evs = soak.slo_events()

    # Goodput over the STORM window (arrivals open -> now), not process
    # lifetime: the elastic arm's pre-storm warm bring-up is
    # provisioning time, not serving time, and must not dilute its
    # throughput against the static arm's.
    wall_s = time.time() - (soak.arrival_t0 or soak.t0)
    done_n = by_status.get("done", 0)

    byte_checked, byte_identical, mismatches = _byte_parity(
        soak, acks, results, workdir, opts.verify)

    ok = (not budget_blown and not lost and not duplicated
          and not soak.unsubmitted and not soak.rejected
          and not soak.journal_ids()
          and by_status.get("failed", 0) == 0
          and byte_identical == byte_checked
          and not soak.status_violations
          and soak.replica_kills >= 1)
    if soak._elastic():
        # The elastic arm must actually have scaled — a run that never
        # left min_replicas proved nothing about the controller.
        ok = ok and len(ups) >= 1 and soak.max_active_seen \
            > (opts.min_replicas or opts.replicas)
    return {
        "ok": ok, "mode": "autoscale",
        "elastic": soak._elastic(), "seed": opts.seed, "jobs": n,
        "min_replicas": opts.min_replicas or opts.replicas,
        "max_replicas": opts.max_replicas or opts.replicas,
        "warm_spares": opts.warm_spares, "shed": bool(opts.shed),
        "tenant_quotas": opts.tenant_quotas,
        "spikes": [[round(s, 2), d, m] for s, d, m in spikes],
        "kill_at_s": round(kill_at, 2),
        "accepted": len(acks), "rejected": len(soak.rejected),
        "unsubmitted": len(soak.unsubmitted),
        "gave_up": len(gave_up),
        "gave_up_by_tenant": gave_up_by_tenant,
        "terminal_by_status": by_status,
        "deadline_deaths": deadline_deaths,
        "lost": lost, "duplicated": duplicated,
        "journal_leftover": soak.journal_ids(),
        "replica_kills": soak.replica_kills,
        "shed_events": slo_evs["shed"],
        "quota_events": slo_evs["tenant_quota"],
        "shed_retries": soak.shed_retries,
        "quota_retries": soak.quota_retries,
        "shed_fraction": round(len(gave_up) / n, 3),
        "attainment": attainment,
        "attainment_overall": attainment_overall,
        "goodput_done_per_min": round(60.0 * done_n / wall_s, 2),
        "scale_ups": len(ups), "scale_downs": len(downs),
        "scale_up_reaction_p50_s": _percentile(reactions, 0.5),
        "scale_up_reaction_max_s": _percentile(reactions, 1.0),
        "spike_to_scale_s": spike_to_scale,
        "max_active_seen": soak.max_active_seen,
        "warm_pool_events": warm_outcomes,
        "failovers": len(soak.failover_events()),
        "status_checks": soak.status_checks,
        "status_violations": soak.status_violations,
        "byte_checked": byte_checked, "byte_identical": byte_identical,
        "mismatches": mismatches,
        "budget_blown": budget_blown,
        "wall_s": round(wall_s, 1),
    }


class _Relay:
    """A userspace TCP partition injector for ONE replica: listens on
    its own port, forwards byte streams to the replica's real address,
    and can blackhole each direction independently (``drop_to_replica``
    / ``drop_to_client``). Blackholing is accept-then-discard: SYNs
    still complete (the kernel backlog answers those), but bytes die in
    the relay — observably identical to an asymmetric partition for the
    length-prefixed JSONL protocol, where a request that draws no reply
    is a dead peer. Standard library only."""

    def __init__(self, backend: str):
        host, port = backend.rsplit(":", 1)
        self.backend = (host, int(port))
        self.drop_to_replica = threading.Event()
        self.drop_to_client = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(64)
        self._srv.settimeout(0.25)
        self.addr = f"127.0.0.1:{self._srv.getsockname()[1]}"
        threading.Thread(target=self._accept_loop,
                         name="chaos-relay", daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                back = socket.create_connection(self.backend, timeout=10)
            except OSError:
                conn.close()
                continue
            with self._lock:
                self._conns += [conn, back]
            threading.Thread(target=self._pump,
                             args=(conn, back, self.drop_to_replica),
                             daemon=True).start()
            threading.Thread(target=self._pump,
                             args=(back, conn, self.drop_to_client),
                             daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              drop: threading.Event) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if drop.is_set():
                    continue       # the partition: read and discard
                dst.sendall(data)
        except OSError:
            pass
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def partition(self, to_replica: bool = True,
                  to_client: bool = True) -> None:
        if to_replica:
            self.drop_to_replica.set()
        if to_client:
            self.drop_to_client.set()

    def heal(self) -> None:
        self.drop_to_replica.clear()
        self.drop_to_client.clear()

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class PartitionSoak(RouterSoak):
    """Soak state for partition mode. Unlike RouterSoak, the HARNESS
    owns the replica daemons (the router runs --remote-replicas, so it
    adopts and fences but never forks), which is what lets a relay sit
    between the router and r0: r0's published tcp_addr file is
    overwritten with the relay's address after boot, and the router
    (deliberately) keeps using the published address instead of the
    daemon's self-reported direct one."""

    def __init__(self, opts, workdir: str):
        super().__init__(opts, workdir)
        self.replica_procs: Dict[str, subprocess.Popen] = {}
        self.relay: Optional[_Relay] = None
        self.router_serial = 0
        self.router_metrics_files: List[str] = []
        self.standby: Optional[subprocess.Popen] = None
        self.takeover_s: List[float] = []
        self.degraded_status_ok = 0
        self.degraded_submits = 0
        self.degraded_results_seen = 0
        self.quiesce_rcs: List[Optional[int]] = []

    # ---- fleet the harness owns -------------------------------------

    def _replica_argv(self, i: int) -> List[str]:
        rdir = os.path.join(self.fleet, f"r{i}")
        return [sys.executable, "-m", "g2vec_tpu_torch", "serve",
                "--socket", os.path.join(rdir, "sock"),
                "--state-dir", os.path.join(rdir, "state"),
                "--listen", "127.0.0.1:0",
                "--device", self.opts.device,
                "--cache-dir", os.path.join(self.wd, "cache"),
                "--queue-depth", "64", "--max-join", "6",
                "--metrics-jsonl", os.path.join(rdir, "metrics.jsonl")]

    def launch_replicas(self) -> None:
        for i in range(self.opts.replicas):
            rdir = os.path.join(self.fleet, f"r{i}")
            os.makedirs(os.path.join(rdir, "state"), exist_ok=True)
            log = open(os.path.join(rdir, "serve.log"), "a")
            self.replica_procs[f"r{i}"] = subprocess.Popen(
                self._replica_argv(i), env=self.env, stdout=log,
                stderr=subprocess.STDOUT)
            log.close()
        deadline = time.time() + 600
        for i in range(self.opts.replicas):
            af = os.path.join(self.fleet, f"r{i}", "state", "tcp_addr")
            while time.time() < deadline:
                try:
                    with open(af) as fh:
                        if fh.read().strip():
                            break
                except OSError:
                    pass
                if self.replica_procs[f"r{i}"].poll() is not None:
                    raise RuntimeError(f"replica r{i} died during boot")
                time.sleep(0.1)
            else:
                raise RuntimeError(f"replica r{i} never bound")
        # The relay slides in front of r0: real address behind it, the
        # relay's address published where the router (and fleet_addrs)
        # will look.
        af0 = os.path.join(self.fleet, "r0", "state", "tcp_addr")
        with open(af0) as fh:
            real = fh.read().strip()
        self.relay = _Relay(real)
        with open(af0 + ".tmp", "w") as fh:
            fh.write(self.relay.addr + "\n")
        os.replace(af0 + ".tmp", af0)
        self.note(f"replicas up; relay {self.relay.addr} fronts "
                  f"r0 ({real})")

    # ---- HA router pair ---------------------------------------------

    def _router_argv(self, standby: bool = False) -> List[str]:
        self.router_serial += 1
        m = os.path.join(self.wd,
                         f"router-metrics-{self.router_serial}.jsonl")
        self.router_metrics_files.append(m)
        argv = [sys.executable, "-m", "g2vec_tpu_torch", "serve",
                "--replicas", str(self.opts.replicas),
                "--listen", "127.0.0.1:0",
                "--state-dir", self.fleet,
                "--remote-replicas",
                "--lease-ttl-s", str(self.opts.lease_ttl),
                "--device", self.opts.device,
                "--cache-dir", os.path.join(self.wd, "cache"),
                "--queue-depth", "64", "--max-join", "6",
                "--probe-interval", "0.3", "--probe-deadline", "1.0",
                "--metrics-jsonl", m]
        if standby:
            argv.append("--standby")
        return argv

    def launch_standby(self) -> None:
        argv = self._router_argv(standby=True)
        log = open(self.router_log, "a")
        self.standby = subprocess.Popen(argv, env=self.env, stdout=log,
                                        stderr=subprocess.STDOUT)
        log.close()
        self.note(f"standby router #{self.router_serial} watching "
                  f"the lease")

    def await_takeover(self, old_addr: str, t_from: float,
                       timeout: float = 90.0) -> bool:
        """Takeover latency as a CLIENT measures it: the moment a
        router at a NEW published address answers status. The router's
        own leader_elected takeover_s starts at its standby loop, not
        at the kill — this is the end-to-end number."""
        from g2vec_tpu_torch.serve import client, protocol

        addr_file = os.path.join(self.fleet, "router_addr")
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                with open(addr_file) as fh:
                    a = fh.read().strip()
            except OSError:
                a = ""
            if a and a != old_addr:
                try:
                    if client.status(a, timeout=5.0):
                        took = time.time() - t_from
                        self.addr = a
                        self.proc = self.standby
                        self.standby = None
                        self.takeover_s.append(took)
                        self.note(f"takeover: {a} answering "
                                  f"{took:.2f}s after the fault")
                        return True
                except (OSError, client.ServeConnectionLost,
                        protocol.ProtocolError):
                    pass
            time.sleep(0.1)
        return False

    # ---- accounting across every router incarnation -----------------

    def router_events(self, kinds: Tuple[str, ...]) -> List[dict]:
        out = []
        for path in self.router_metrics_files:
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        if ev.get("event") in kinds:
                            out.append(ev)
            except OSError:
                pass
        return out

    def failover_events(self) -> List[dict]:
        return self.router_events(("failover",))

    def replica_events(self, name: str, kind: str) -> List[dict]:
        out = []
        try:
            with open(os.path.join(self.fleet, name,
                                   "metrics.jsonl")) as f:
                for line in f:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if ev.get("event") == kind:
                        out.append(ev)
        except OSError:
            pass
        return out

    # ---- submission (takeover- and zombie-aware) --------------------

    def submit_one(self, k: int, job: dict) -> None:
        """Same exactly-once submit loop as RouterSoak, with two more
        transient rejections in the retry set: ``stale_epoch`` (the
        attempt raced a takeover and reached the zombie — the SAME idem
        key retried against the new leader is safe by construction) and
        ``fenced`` (the ring briefly offered a quarantined replica).
        ``self.addr`` is re-read every attempt, so retries follow the
        published router_addr across takeovers."""
        from g2vec_tpu_torch.serve import client

        rng = random.Random((self.opts.seed << 20) ^ k)
        priority = "interactive" if rng.random() < 0.3 else "batch"
        deadline_s = (round(rng.uniform(2.0, 8.0), 2)
                      if rng.random() < 0.15 else None)
        idem = f"soak-{self.opts.seed}-{k}"
        for attempt in range(16):
            try:
                evs = client.submit_job(
                    self.addr, job, tenant=f"t{k % 3}", timeout=600,
                    priority=priority, deadline_s=deadline_s,
                    idem_key=idem)
                if evs and evs[-1].get("event") == "rejected":
                    if evs[-1].get("error") in (
                            "no_replicas", "draining", "stale_epoch",
                            "fenced"):
                        raise OSError(f"transient: {evs[-1]['error']}")
                    with self.lock:
                        self.rejected.append(k)
                    return
                jid = evs[0].get("job_id") if evs else None
                if jid:
                    with self.lock:
                        self.acks[jid] = {"k": k, "job": job,
                                          "deadline_s": deadline_s}
                    return
                break
            except client.ServeConnectionLost as e:
                if e.job_id:
                    with self.lock:
                        self.acks[e.job_id] = {"k": k, "job": job,
                                               "deadline_s": deadline_s}
                    return
            except (client.ServeTimeout, OSError):
                pass
            time.sleep(min(3.0, 0.2 * (2 ** attempt))
                       + rng.uniform(0.0, 0.25))
        with self.lock:
            self.unsubmitted.append(k)

    # ---- degraded-mode client drill ---------------------------------

    def degraded_drill(self, round_i: int, paths: dict,
                       native_ok: bool) -> None:
        """Runs INSIDE a takeover gap: no router is answering, so the
        client falls back to the fleet's published replica addresses —
        status roll-up, then a keyed submit (rotating the key when the
        deterministic target turns out to be the fenced replica), then
        the reconcile read of the job it just placed."""
        from g2vec_tpu_torch.serve import client

        st = client.degraded_status(self.fleet)
        if st.get("replicas"):
            self.degraded_status_ok += 1
        k = self.opts.jobs + round_i
        job = self.make_job(k, paths, native_ok)
        for j in range(6):
            key = f"deg-{self.opts.seed}-{round_i}-{j}"
            try:
                evs = client.degraded_submit(self.fleet, job,
                                             tenant="degraded",
                                             idem_key=key, timeout=600)
            except (client.ServeConnectionLost, client.ServeTimeout,
                    OSError):
                return
            if evs and evs[-1].get("event") == "rejected":
                continue       # crc32 target was the fenced replica
            jid = evs[0].get("job_id") if evs else None
            if not jid:
                return
            with self.lock:
                self.acks[jid] = {"k": k, "job": job,
                                  "deadline_s": None}
                self.degraded_submits += 1
            # The reconcile read: a durable record (it carries the
            # terminal ``status``) or an honest ``pending`` — anything
            # but a connection-level failure.
            rec = client.degraded_result(self.fleet, jid)
            if rec.get("status") or rec.get("event") == "pending":
                self.degraded_results_seen += 1
            self.note(f"degraded drill #{round_i}: submitted {jid} "
                      f"router-less (key {key})")
            return

    # ---- quiesce ----------------------------------------------------

    def stop_fleet(self) -> None:
        """The harness owns the daemons (remote-replicas mode: the
        router's own stop_all skips non-local replicas), so it drains
        them itself. The fenced r0 exits too — its parked jobs were
        migrated long ago, and drain does not need admission."""
        for name in sorted(self.replica_procs):
            proc = self.replica_procs[name]
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        for name in sorted(self.replica_procs):
            proc = self.replica_procs[name]
            try:
                self.quiesce_rcs.append(proc.wait(timeout=120))
            except subprocess.TimeoutExpired:
                proc.kill()
                self.quiesce_rcs.append(proc.wait())


def run_partition_soak(opts, workdir: str) -> dict:
    """The partition-tolerance drill: false-dead fencing + replica
    self-quarantine under a relay blackhole, zombie-leader command
    rejection after a SIGSTOP-induced takeover, a chain of router
    SIGKILLs each ridden out by a standby, and degraded-mode client
    drills inside every takeover gap — all under the fleet-wide
    exactly-once accounting of the router soak."""
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.serve import client, leader

    soak = PartitionSoak(opts, workdir)
    native_ok = bool(shutil.which("g++")) and opts.stream_frac > 0
    spec = SyntheticSpec(n_good=24, n_poor=20, module_size=12,
                         n_background=24, n_expr_only=4, n_net_only=4,
                         module_chords=2, background_edges=40, seed=7)
    paths = write_synthetic_tsv(spec, os.path.join(workdir, "data"))
    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)

    n = opts.jobs
    rng = soak.rng
    arrivals, t = [], 0.0
    for _ in range(n):
        arrivals.append(t)
        t += rng.expovariate(1.0 / opts.mean_arrival)

    soak.note(f"partition soak: {n} jobs over {opts.replicas} replicas "
              f"(harness-owned), lease ttl {opts.lease_ttl}s, "
              f"{opts.takeovers} takeover round(s), seed {opts.seed}")
    soak.launch_replicas()
    soak.launch_router()
    soak.launch_standby()

    threads: List[threading.Thread] = []
    deg_threads: List[threading.Thread] = []

    def arrival_loop():
        t0 = time.time()
        jobs = [soak.make_job(k, paths, native_ok) for k in range(n)]
        for k in range(n):
            now = time.time() - t0
            if now < arrivals[k]:
                time.sleep(arrivals[k] - now)
            th = threading.Thread(target=soak.submit_one,
                                  args=(k, jobs[k]), daemon=True)
            th.start()
            threads.append(th)

    arr = threading.Thread(target=arrival_loop, daemon=True)
    arr.start()
    deadline = soak.t0 + opts.budget_s
    budget_blown = False
    r0_state = os.path.join(soak.fleet, "r0", "state")
    drill = {"fence_epoch": None, "fenced_at": None,
             "quarantine_to_park_s": None, "fenced_stays_out": False,
             "stale_probe_rejects": 0, "stale_probe_targets": 0,
             "zombie_rejects": 0}

    def overdue() -> bool:
        return time.time() > deadline

    # ---- phase 1: false-dead — partition r0, fence, quarantine ------
    t_wait = time.time() + 30
    while time.time() < t_wait and not overdue():
        with soak.lock:
            if len(soak.acks) >= min(3, n):
                break
        time.sleep(0.2)
    soak.note("phase 1: blackholing r0's replies (asymmetric), then "
              "both directions")
    soak.relay.partition(to_replica=False, to_client=True)
    time.sleep(1.0)
    soak.relay.partition(to_replica=True, to_client=True)
    marker_path = leader.fence_marker_path(r0_state)
    t_limit = time.time() + 60
    while not os.path.exists(marker_path) and time.time() < t_limit \
            and not overdue():
        time.sleep(0.1)
    if os.path.exists(marker_path):
        try:
            with open(marker_path) as fh:
                raw = json.load(fh)
            drill["fence_epoch"] = int(raw.get("epoch", 0))
            drill["fenced_at"] = float(raw.get("fenced_at", 0.0))
        except (OSError, ValueError, TypeError):
            drill["fence_epoch"] = 0
        soak.note(f"r0 fenced at epoch {drill['fence_epoch']} "
                  f"(false-dead: the daemon is alive behind the relay)")
    t_limit = time.time() + 60
    quarantine = None
    while quarantine is None and time.time() < t_limit and not overdue():
        evs = soak.replica_events("r0", "quarantine")
        quarantine = evs[0] if evs else None
        time.sleep(0.2)
    if quarantine and drill["fenced_at"]:
        drill["quarantine_to_park_s"] = round(
            quarantine["ts"] - drill["fenced_at"], 3)
        soak.note(f"r0 self-quarantined {drill['quarantine_to_park_s']}s "
                  f"after the marker landed ({quarantine.get('parked')} "
                  f"job(s) parked)")
    soak.relay.heal()
    soak.note("phase 1: partition healed — r0 must STAY out of the ring")
    time.sleep(3.0)
    st = soak.router_status()
    if st:
        r0 = (st.get("replicas") or {}).get("r0") or {}
        drill["fenced_stays_out"] = r0.get("state") not in ("healthy",
                                                            "suspect")

    # ---- phase 2: zombie leader — SIGSTOP past the ttl --------------
    if not overdue():
        soak.note("phase 2: SIGSTOP active router past its lease ttl")
        old_addr, old_proc = soak.addr, soak.proc
        t_stop = time.time()
        try:
            os.kill(old_proc.pid, signal.SIGSTOP)
        except OSError:
            pass
        soak.await_takeover(old_addr, t_stop)
        soak.launch_standby()
        # Deterministic stale-epoch matrix: prime every replica's
        # watermark with the NEW leader's epoch, then replay at
        # epoch-1 — each must answer the structured stale_epoch
        # rejection (the fenced r0 included: the gate runs before the
        # quarantine check).
        lease_st = leader.read_lease(
            os.path.join(soak.fleet, leader.LEASE_FILE))
        epoch = lease_st.epoch if lease_st else 0
        if epoch > 1:
            for addr in client.fleet_addrs(soak.fleet):
                drill["stale_probe_targets"] += 1
                try:
                    list(client.request(addr, {"op": "cancel",
                                               "job_id": "fence-probe",
                                               "router_epoch": epoch},
                                        timeout=10.0))
                    evs = list(client.request(
                        addr, {"op": "cancel",
                               "job_id": "fence-probe",
                               "router_epoch": epoch - 1},
                        timeout=10.0))
                    if evs and evs[-1].get("error") == "stale_epoch":
                        drill["stale_probe_rejects"] += 1
                except (OSError, client.ServeConnectionLost):
                    pass
        # Wake the old leader: it is a zombie now (its renew fails),
        # and every mutating command it still emits carries its stale
        # epoch — the daemons must refuse each one.
        try:
            os.kill(old_proc.pid, signal.SIGCONT)
        except OSError:
            pass
        try:
            client.cancel(old_addr, "zombie-victim", timeout=30.0)
        except (OSError, client.ServeConnectionLost):
            pass
        t_limit = time.time() + 20
        while time.time() < t_limit and not overdue():
            zr = [ev for ev in soak.router_events(("stale_epoch",))
                  if ev.get("side") == "router"]
            if zr:
                drill["zombie_rejects"] = len(zr)
                break
            time.sleep(0.25)
        soak.note(f"zombie drill: {drill['stale_probe_rejects']}/"
                  f"{drill['stale_probe_targets']} replicas rejected "
                  f"the stale epoch; {drill['zombie_rejects']} zombie "
                  f"command(s) refused")
        # A zombie is never shut down gracefully — its exit path would
        # SIGTERM replicas now owned by the new leader. SIGKILL only.
        try:
            os.kill(old_proc.pid, signal.SIGKILL)
        except OSError:
            pass
        old_proc.wait()

    # ---- phase 3: takeover chain with degraded-mode gaps ------------
    for round_i in range(opts.takeovers):
        if overdue():
            break
        soak.note(f"phase 3.{round_i}: SIGKILL active router "
                  f"(takeover chain)")
        old_addr, victim = soak.addr, soak.proc
        t_kill = time.time()
        try:
            os.kill(victim.pid, signal.SIGKILL)
        except OSError:
            pass
        victim.wait()
        dth = threading.Thread(target=soak.degraded_drill,
                               args=(round_i, paths, native_ok),
                               daemon=True)
        dth.start()
        deg_threads.append(dth)
        soak.await_takeover(old_addr, t_kill)
        soak.launch_standby()

    # ---- drain ------------------------------------------------------
    arr.join(timeout=60)
    for th in threads:
        th.join(timeout=120)
    for th in deg_threads:
        th.join(timeout=600)
    while not overdue():
        if soak.proc.poll() is not None:
            # The active died without us killing it: the standby is the
            # recovery path even here.
            soak.note("active router self-death mid-drain — waiting "
                      "for the standby")
            if not soak.await_takeover(soak.addr, time.time()):
                break
            soak.launch_standby()
        with soak.lock:
            acked = set(soak.acks)
        if acked <= set(soak.results()) and not soak.journal_ids():
            break
        time.sleep(0.5)
    else:
        budget_blown = True
        soak.note("BUDGET BLOWN — abandoning the drill")
    # Kill the waiting standby FIRST: a clean router shutdown releases
    # the lease, and a live standby would take over and reboot the
    # fleet the harness is about to stop.
    if soak.standby is not None and soak.standby.poll() is None:
        soak.standby.kill()
        soak.standby.wait()
    try:
        client.shutdown(soak.addr)
        soak.proc.wait(timeout=180)
    except (OSError, client.ServeConnectionLost,
            subprocess.TimeoutExpired):
        soak.proc.kill()
        soak.proc.wait()
    soak.stop_fleet()
    soak.relay.close()

    # ---- accounting --------------------------------------------------
    results = soak.results()
    locations = soak.result_locations()
    with soak.lock:
        acks = dict(soak.acks)
    lost = sorted(jid for jid in acks if jid not in results)
    term_counts = soak.terminal_event_counts()
    duplicated = sorted(set(
        [jid for jid, c in term_counts.items() if c > 1]
        + [jid for jid, where in locations.items() if len(where) > 1]))
    by_status: Dict[str, int] = {}
    for jid in acks:
        st_ = results.get(jid, {}).get("status", "LOST")
        by_status[st_] = by_status.get(st_, 0) + 1

    # The fenced replica's silence: after the marker landed, r0 must
    # never mint another terminal state or result record (quiesce-drain
    # job_drained notices are fine — those are parks, not results).
    r0_violations: List[str] = []
    if drill["fenced_at"]:
        for ev in soak.replica_events("r0", "job_state"):
            if ev.get("state") in TERMINAL_STATES \
                    and ev.get("ts", 0.0) > drill["fenced_at"] + 0.05:
                r0_violations.append(
                    f"terminal {ev.get('state')} for "
                    f"{ev.get('job_id')} at +"
                    f"{ev['ts'] - drill['fenced_at']:.2f}s")
        resd = os.path.join(r0_state, "results")
        if os.path.isdir(resd):
            for fn in os.listdir(resd):
                path = os.path.join(resd, fn)
                try:
                    if os.stat(path).st_mtime > \
                            drill["fenced_at"] + 0.05:
                        r0_violations.append(f"result file {fn} "
                                             f"written after fencing")
                except OSError:
                    pass

    failovers = soak.failover_events()
    requeue_lat = [ev.get("latency_s", 0.0) for ev in failovers]
    elected = soak.router_events(("leader_elected",))
    daemon_stales = sum(
        len([ev for ev in soak.replica_events(f"r{i}", "stale_epoch")
             if ev.get("side") == "daemon"])
        for i in range(opts.replicas))

    byte_checked, byte_identical, mismatches = _byte_parity(
        soak, acks, results, workdir, opts.verify)

    ok = (not budget_blown and not lost and not duplicated
          and not soak.unsubmitted and not soak.journal_ids()
          and by_status.get("failed", 0) == 0
          and byte_identical == byte_checked
          and (drill["fence_epoch"] or 0) >= 1
          and quarantine is not None
          and not r0_violations
          and drill["fenced_stays_out"]
          and drill["stale_probe_targets"] > 0
          and drill["stale_probe_rejects"]
          == drill["stale_probe_targets"]
          and drill["zombie_rejects"] >= 1
          and len(soak.takeover_s) >= opts.takeovers + 1
          and soak.degraded_status_ok >= 1
          and soak.degraded_submits >= 1)
    return {
        "ok": ok, "mode": "partition", "seed": opts.seed, "jobs": n,
        "replicas": opts.replicas, "lease_ttl_s": opts.lease_ttl,
        "accepted": len(acks), "rejected": len(soak.rejected),
        "unsubmitted": len(soak.unsubmitted),
        "terminal_by_status": by_status,
        "lost": lost, "duplicated": duplicated,
        "journal_leftover": soak.journal_ids(),
        "fence_epoch": drill["fence_epoch"],
        "quarantine_to_park_s": drill["quarantine_to_park_s"],
        "quarantine_parked": (quarantine or {}).get("parked"),
        "fenced_replica_violations": r0_violations,
        "fenced_stays_out": drill["fenced_stays_out"],
        "stale_probe_rejects": drill["stale_probe_rejects"],
        "stale_probe_targets": drill["stale_probe_targets"],
        "zombie_rejects": drill["zombie_rejects"],
        "daemon_stale_events": daemon_stales,
        "leader_elections": len(elected),
        "takeovers": len(soak.takeover_s),
        "takeover_p50_s": _percentile(soak.takeover_s, 0.5),
        "takeover_p99_s": _percentile(soak.takeover_s, 0.99),
        "degraded_status_ok": soak.degraded_status_ok,
        "degraded_submits": soak.degraded_submits,
        "degraded_results_seen": soak.degraded_results_seen,
        "failovers": len(failovers),
        "requeue_p50_s": _percentile(requeue_lat, 0.5),
        "requeue_p99_s": _percentile(requeue_lat, 0.99),
        "replica_quiesce_rcs": soak.quiesce_rcs,
        "byte_checked": byte_checked, "byte_identical": byte_identical,
        "mismatches": mismatches,
        "budget_blown": budget_blown,
        "wall_s": round(time.time() - soak.t0, 1),
    }


def run_soak(opts, workdir: str) -> dict:
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.serve import client

    soak = Soak(opts, workdir)
    native_ok = bool(shutil.which("g++")) and opts.stream_frac > 0
    spec = SyntheticSpec(n_good=24, n_poor=20, module_size=12,
                         n_background=24, n_expr_only=4, n_net_only=4,
                         module_chords=2, background_edges=40, seed=7)
    paths = write_synthetic_tsv(spec, os.path.join(workdir, "data"))
    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)

    n = opts.jobs
    n_ops = opts.chaos_ops or max(3, n // 8)
    rng = soak.rng
    arrivals, t = [], 0.0
    for _ in range(n):
        arrivals.append(t)
        t += rng.expovariate(1.0 / opts.mean_arrival)
    op_pool = ["sigkill", "drain", "cancel", "fault_train"]
    if native_ok:
        op_pool += ["fault_stream_ckpt", "fault_drain_seam"]
    ops = [op_pool[i % len(op_pool)] for i in range(n_ops)]
    rng.shuffle(ops)

    soak.note(f"soak: {n} jobs (stream_frac="
              f"{opts.stream_frac if native_ok else 0}), "
              f"{n_ops} chaos ops {ops}, seed {opts.seed}")
    soak.launch()

    threads: List[threading.Thread] = []

    def arrival_loop():
        t0 = time.time()
        jobs = [soak.make_job(k, paths, native_ok) for k in range(n)]
        for k in range(n):
            now = time.time() - t0
            if now < arrivals[k]:
                time.sleep(arrivals[k] - now)
            th = threading.Thread(target=soak.submit_one,
                                  args=(k, jobs[k]), daemon=True)
            th.start()
            threads.append(th)

    arr = threading.Thread(target=arrival_loop, daemon=True)
    arr.start()

    deadline = soak.t0 + opts.budget_s
    next_chaos = time.time() + rng.uniform(1.0, opts.chaos_every)
    budget_blown = False
    while True:
        if time.time() > deadline:
            budget_blown = True
            soak.note("BUDGET BLOWN — abandoning the storm")
            break
        if soak.proc.poll() is not None:
            # Died on its own: an armed fault plan fired.
            soak.relaunch_after_death(
                f"self-death rc={soak.proc.returncode}")
        if ops and time.time() >= next_chaos:
            soak.run_chaos_op(ops.pop(0))
            next_chaos = time.time() + rng.uniform(
                0.5 * opts.chaos_every, 1.5 * opts.chaos_every)
        if not ops and not arr.is_alive() \
                and all(not th.is_alive() for th in threads):
            with soak.lock:
                acked = set(soak.acks)
            if acked and acked <= set(soak.results()) \
                    and not soak.journal_ids():
                break
        time.sleep(0.25)

    # Quiesce: a clean daemon finishes whatever the storm left behind.
    arr.join(timeout=60)
    for th in threads:
        th.join(timeout=120)
    while not budget_blown and time.time() < deadline:
        if soak.proc.poll() is not None:
            soak.relaunch_after_death(
                f"self-death rc={soak.proc.returncode}")
        with soak.lock:
            acked = set(soak.acks)
        if acked <= set(soak.results()) and not soak.journal_ids():
            break
        time.sleep(0.5)
    try:
        client.shutdown(soak.sock)
        soak.proc.wait(timeout=120)
    except (OSError, client.ServeConnectionLost,
            subprocess.TimeoutExpired):
        soak.proc.kill()
        soak.proc.wait()

    # ---- accounting ------------------------------------------------------
    results = soak.results()
    with soak.lock:
        acks = dict(soak.acks)
    lost = sorted(jid for jid in acks if jid not in results)
    term_counts = soak.terminal_event_counts()
    duplicated = sorted(jid for jid, c in term_counts.items() if c > 1)
    by_status: Dict[str, int] = {}
    for jid in acks:
        st = results.get(jid, {}).get("status", "LOST")
        by_status[st] = by_status.get(st, 0) + 1

    byte_checked, byte_identical, mismatches = _byte_parity(
        soak, acks, results, workdir, opts.verify)

    ok = (not budget_blown and not lost and not duplicated
          and not soak.unsubmitted and not soak.journal_ids()
          and by_status.get("failed", 0) == 0
          and byte_identical == byte_checked
          and all(rc == 0 for rc in soak.drain_rcs))
    return {
        "ok": ok, "seed": opts.seed, "jobs": n,
        "accepted": len(acks), "rejected": len(soak.rejected),
        "unsubmitted": len(soak.unsubmitted),
        "terminal_by_status": by_status,
        "lost": lost, "duplicated": duplicated,
        "journal_leftover": soak.journal_ids(),
        "kills": soak.kills, "drains": soak.drains,
        "drain_exit_codes": soak.drain_rcs,
        "fault_injections": soak.fault_injections,
        "cancels_sent": soak.cancels_sent,
        "recover_p50_s": _percentile(soak.recoveries, 0.5),
        "recover_p99_s": _percentile(soak.recoveries, 0.99),
        "recoveries": len(soak.recoveries),
        "byte_checked": byte_checked, "byte_identical": byte_identical,
        "mismatches": mismatches,
        "budget_blown": budget_blown,
        "wall_s": round(time.time() - soak.t0, 1),
    }


def main(argv: Optional[List[str]] = None) -> int:
    opts = build_parser().parse_args(argv)
    workdir = opts.workdir or tempfile.mkdtemp(prefix="g2vec-chaos-")
    os.makedirs(workdir, exist_ok=True)
    try:
        if opts.partition:
            if opts.replicas < 2:
                opts.replicas = 3
            summary = run_partition_soak(opts, workdir)
        elif opts.autoscale:
            if opts.replicas < 1:
                opts.replicas = 1
            summary = run_autoscale_soak(opts, workdir)
        elif opts.replicas:
            summary = run_router_soak(opts, workdir)
        else:
            summary = run_soak(opts, workdir)
    finally:
        if not opts.keep and not opts.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(summary, indent=1), flush=True)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
