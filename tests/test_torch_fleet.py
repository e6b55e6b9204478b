"""The port's fleet (``g2vec_tpu_torch/resilience/fleet.py``) against the
reference's (``g2vec_tpu/resilience/fleet.py``, which imports no JAX).

- Planning: ``plan_mesh`` over 1-16 devices and several preferred model
  sizes, and ``_scrub_fleet_argv`` on ``tests/test_fleet.py``'s argv and
  its ``=`` forms, equal the reference's.
- Liveness (``tests/test_fleet.py:74-190``'s cases): a heartbeat file and
  event carry the reference's keys; ``describe_ranks`` gives the
  reference's string for the same liveness files; the ``heartbeat`` seam
  ends only the thread; the watchdog passes results and errors through,
  times out naming its suspects and runs inline when off;
  ``stage_barrier`` flags a straggler and is inert in one process or with
  no fleet flag; ``PeerTimeoutError`` is one class under its two names and
  classifies retryable; a store collective records its entry in the
  liveness file and its timeout names the missing rank's phase.
- The CLI on the CPU (bf16, the plain versions of the kernels): a
  ``--fleet-size 2 --checkpoint-layout sharded`` run whose rank 1 is
  SIGKILLed at ``checkpoint_finalize`` logs ``fleet_peer_death`` and
  ``fleet_replan`` 2x1 -> 1x1, resumes on the survivor and writes the
  single-process run's bytes, every event within the reference's schema;
  a rank SIGKILLed mid-``train`` under ``--fleet-watchdog-deadline`` is
  named by its peer's ``PeerTimeoutError`` with its last phase and
  collective.
"""
import ast
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from g2vec_tpu.resilience import fleet as jfleet
from g2vec_tpu_torch.parallel import hostcomm
from g2vec_tpu_torch.resilience import faults, fleet

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _inert(monkeypatch):
    """Fleet config, heartbeat and fault state are process-global."""
    for name in (faults.ENV_PLAN, faults.ENV_STATE, "G2VEC_PROCESS_ID",
                 "G2VEC_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    faults._reset_for_tests()
    fleet.configure()
    jfleet.configure()
    yield
    for mod in (fleet, jfleet):
        mod.stop_heartbeat()
        mod.configure()
    faults._reset_for_tests()


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", range(1, 17))
@pytest.mark.parametrize("prefer_model", [1, 2, 3, 4, 8])
def test_plan_mesh_is_the_reference(n_devices, prefer_model):
    got = fleet.plan_mesh(n_devices, prefer_model=prefer_model)
    assert got == jfleet.plan_mesh(n_devices, prefer_model=prefer_model)
    assert got[0] * got[1] == n_devices


def test_plan_mesh_refuses_no_devices():
    for mod in (fleet, jfleet):
        with pytest.raises(ValueError, match="0 devices"):
            mod.plan_mesh(0)


_ARGV = ["e.txt", "c.txt", "n.txt", "out", "--fleet-size", "2",
         "--fleet-devices-per-rank", "2", "--mesh", "4x1", "--supervise",
         "--supervise-retries", "3", "--fault-plan", "stage=load",
         "--resume", "--fleet-watchdog-deadline", "5",
         "--checkpoint-dir", "ck"]


@pytest.mark.parametrize("argv", [
    _ARGV,
    ["e", "c", "n", "o", "--fleet-size=2", "--mesh=2x1", "--device", "cpu",
     "--supervise-backoff=0", "--fault-plan=stage=train", "-e", "4"],
    ["e", "c", "n", "o", "--checkpoint-layout", "sharded", "--fleet-size",
     "3", "--fleet-liveness-dir", "L", "--resume", "--supervise"],
], ids=["reference", "equals-forms", "keeps-child-flags"])
def test_scrub_fleet_argv_is_the_reference(argv):
    out = fleet._scrub_fleet_argv(list(argv))
    assert out == jfleet._scrub_fleet_argv(list(argv))
    assert not any(t.startswith(("--fleet-size", "--mesh", "--fault-plan",
                                 "--supervise", "--resume")) for t in out)


_REFUSALS = [
    dict(fleet_size=1), dict(fleet_size=-1), dict(fleet_devices_per_rank=-1),
    dict(fleet_heartbeat_interval=0.0), dict(fleet_watchdog_deadline=-1.0),
    dict(fleet_straggler_factor=-1.0), dict(fleet_size=2, checkpoint_dir="ck"),
    dict(fleet_size=2, mesh_shape=(3, 1)), dict(mesh_shape=(0, 1)),
    dict(train_mode="streaming", mesh_shape=(2, 1)),
    dict(train_mode="streaming", fleet_size=2),
    dict(train_mode="streaming", distributed=True),
    dict(train_mode="streaming", checkpoint_dir="ck",
         checkpoint_layout="sharded"),
    dict(batch_seeds=2, fleet_size=2),
    dict(fleet_size=2, mesh_shape=(4, 1), fleet_devices_per_rank=2),
]


@pytest.mark.parametrize("over", _REFUSALS, ids=lambda d: ",".join(d))
def test_config_refuses_as_the_reference_does(over):
    """``validate`` carries the reference's fleet and mesh refusals word
    for word (and accepts what it accepts). The one refusal whose reason
    names the reference's orbax leaves keeps its rule word for word and
    gives the port's own reason."""
    from g2vec_tpu.config import G2VecConfig as JaxConfig
    from g2vec_tpu_torch.config import G2VecConfig

    def outcome(cls):
        try:
            cls(**over).validate()
        except ValueError as e:
            return str(e)
        return None

    port, ref = outcome(G2VecConfig), outcome(JaxConfig)
    if ref is not None and "orbax" in ref:
        rule = ref.split(": ")[0]
        assert port == rule + ": degraded-mesh resume reads the sharded " \
            "layout (rank 0 reads, the survivors receive its leaves)"
    else:
        assert port == ref


def test_cli_parses_the_fleet_flags_as_the_reference_does():
    from g2vec_tpu.config import config_from_args as jargs
    from g2vec_tpu_torch.config import config_from_args

    argv = ["e.txt", "c.txt", "n.txt", "out", "--fleet-size", "2", "--mesh",
            "4x1", "--checkpoint-dir", "ck", "--checkpoint-layout",
            "sharded", "--fleet-watchdog-deadline", "6",
            "--fleet-straggler-factor", "3", "--fleet-liveness-dir", "L",
            "--fleet-heartbeat-interval", "0.5",
            "--fleet-devices-per-rank", "2"]
    got, want = config_from_args(argv), jargs(argv)
    for name in ("fleet_size", "mesh_shape", "checkpoint_layout",
                 "fleet_watchdog_deadline", "fleet_straggler_factor",
                 "fleet_liveness_dir", "fleet_heartbeat_interval",
                 "fleet_devices_per_rank"):
        assert getattr(got, name) == getattr(want, name), name


def test_launcher_refuses_more_devices_per_rank_than_a_rank_sees():
    """In place of the reference's virtual CPU devices: a rank holds only
    the devices this host shows it (one, for ``--device cpu``)."""
    from g2vec_tpu_torch.config import config_from_args

    argv = ["e", "c", "n", "o", "--device", "cpu", "--fleet-size", "2",
            "--fleet-devices-per-rank", "2"]
    with pytest.raises(ValueError, match="needs 2 devices per rank .* only "
                                         "1 visible"):
        fleet.supervise_fleet(config_from_args(argv), argv)
    assert fleet.rank_device_count("cpu") == 1


class _FatalChild:
    """A rank that has already exited 1 with a fatal error on stderr."""
    returncode = 1

    def __init__(self, cmd, env, stdout, stderr):
        stderr.write("ValueError: bad input\n")
        stderr.flush()

    def poll(self):
        return 1

    def wait(self, timeout=None):
        return 1


@pytest.mark.parametrize("named", [False, True])
def test_launcher_removes_only_the_liveness_dir_it_made(named, tmp_path,
                                                        monkeypatch):
    """Without ``--fleet-liveness-dir`` the launcher's own directory (rank
    logs and liveness files) is gone when it returns; a directory the user
    named is kept with the attempt's logs."""
    import tempfile

    from g2vec_tpu_torch.config import config_from_args

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(fleet.subprocess, "Popen", _FatalChild)
    live = tmp_path / "L"
    argv = ["e", "c", "n", "o", "--device", "cpu", "--fleet-size", "2",
            "--supervise-backoff", "0",
            *(["--fleet-liveness-dir", str(live)] if named else [])]
    assert fleet.supervise_fleet(config_from_args(argv), argv,
                                 sleep=lambda s: None) == 1
    left = sorted(p.name for p in tmp_path.iterdir())
    if named:
        assert left == ["L"]
        assert (live / "logs-attempt0" / "rank1.err").read_text() \
            == "ValueError: bad input\n"
    else:
        assert left == []


# ---------------------------------------------------------------------------
# Liveness
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})


def test_heartbeat_file_and_event_carry_the_reference_keys(tmp_path):
    records = []
    for mod, sub in ((fleet, "port"), (jfleet, "jax")):
        rec = _Recorder()
        hb = mod.Heartbeat(str(tmp_path / sub), 0.02, rec, rank=3)
        hb.start()
        hb.note("train")
        deadline = time.time() + 5.0
        while hb.beats < 3 and time.time() < deadline:
            time.sleep(0.01)
        hb.stop()
        live = mod.read_liveness(str(tmp_path / sub), 3)
        records.append((sorted(live), sorted(rec.events[-1]), live["phase"],
                        rec.events[-1]["phase"], live["rank"]))
        assert hb.beats >= 3
    assert records[0] == records[1]
    assert records[0][2:] == ("train", "train", 3)


@pytest.mark.parametrize("case", ["absent", "stale", "fresh", "mixed",
                                  "no-dir"])
def test_describe_ranks_is_the_reference(case, tmp_path, monkeypatch):
    now = 1_000_000.0
    monkeypatch.setattr(time, "time", lambda: now)
    d = str(tmp_path)
    recs = {"stale": {"rank": 1, "ts": now - 120.0, "beats": 7,
                      "phase": "train", "collective": "native_rows",
                      "collective_seq": 4},
            "fresh": {"rank": 2, "ts": now - 1.25, "beats": 40,
                      "phase": "barrier:paths", "collective": "stage/paths",
                      "collective_seq": 9}}
    for rec in recs.values():
        with open(fleet.liveness_path(d, rec["rank"]), "w") as f:
            json.dump(rec, f)
    ranks = {"absent": [5], "stale": [1], "fresh": [2], "mixed": [1, 2, 5],
             "no-dir": [1]}[case]
    for mod in (fleet, jfleet):
        mod.configure(heartbeat_interval=0.5)
    where = None if case == "no-dir" else d
    got = fleet.describe_ranks(ranks, where)
    assert got == jfleet.describe_ranks(ranks, where)
    if case == "no-dir":
        assert got == ""
    elif case == "mixed":
        assert "rank 1: heartbeat stale" in got and \
            "rank 5: no liveness record" in got and "live straggler" in got


def test_heartbeat_fault_seam_ends_only_the_thread(tmp_path):
    faults.install_plan("stage=heartbeat,kind=crash")
    fleet.configure(liveness_dir=str(tmp_path), heartbeat_interval=0.02)
    hb = fleet.start_heartbeat()
    assert fleet.current_heartbeat() is hb
    deadline = time.time() + 5.0
    while hb._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not hb._thread.is_alive()
    assert hb.beats == 1     # only start()'s beat landed


def test_watchdog_passes_results_and_errors_through():
    fleet.configure(watchdog_deadline=5.0)
    assert fleet.collective_watchdog("ok", lambda: 42) == 42
    with pytest.raises(KeyError):
        fleet.collective_watchdog("boom", lambda: {}["x"])


def test_watchdog_times_out_and_names_suspects(tmp_path, monkeypatch):
    fleet.configure(liveness_dir=str(tmp_path), heartbeat_interval=5.0,
                    watchdog_deadline=0.3)
    fleet.start_heartbeat()
    with open(fleet.liveness_path(str(tmp_path), 1), "w") as f:
        json.dump({"rank": 1, "ts": time.time() - 120.0, "beats": 7,
                   "phase": "train", "collective": None,
                   "collective_seq": None}, f)
    monkeypatch.setattr(fleet, "_nranks", lambda: 2)
    t0 = time.time()
    with pytest.raises(fleet.PeerTimeoutError) as ei:
        fleet.collective_watchdog("unit", lambda: time.sleep(30))
    assert time.time() - t0 < 5.0
    assert ei.value.suspects == (1,)
    assert "rank 1" in str(ei.value) and "stale" in str(ei.value)


def test_watchdog_inline_when_disabled():
    fleet.configure(watchdog_deadline=0.0)
    evt = threading.Event()
    assert fleet.collective_watchdog("inline", lambda: evt.is_set()) is False


def test_stage_barrier_flags_stragglers(monkeypatch):
    fleet.configure(watchdog_deadline=5.0, straggler_factor=3.0)
    monkeypatch.setattr(fleet, "_nranks", lambda: 4)
    durs = np.asarray([[0.1], [0.11], [0.09], [1.2]])
    monkeypatch.setattr(hostcomm, "allgather_array",
                        lambda name, arr, deadline=None: durs)
    rec, lines = _Recorder(), []
    fleet.stage_barrier("paths", 0.1, rec, lines.append)
    warns = [e for e in rec.events if e["event"] == "straggler_warning"]
    assert len(warns) == 1 and warns[0]["rank"] == 3
    assert warns[0]["stage"] == "paths"
    assert any("rank 3" in ln for ln in lines)


@pytest.mark.parametrize("case", ["one-process", "no-fleet-flags"])
def test_stage_barrier_is_inert(case, monkeypatch):
    called = []
    monkeypatch.setattr(hostcomm, "allgather_array",
                        lambda *a, **k: called.append(1))
    if case == "one-process":
        fleet.configure(watchdog_deadline=5.0, straggler_factor=3.0)
    else:
        monkeypatch.setattr(fleet, "_nranks", lambda: 2)
    fleet.stage_barrier("load", 0.1)
    assert not called


def test_peer_timeout_is_one_class_and_classifies_retryable():
    from g2vec_tpu_torch.resilience.supervisor import (classify_child,
                                                       classify_exception)

    assert hostcomm.PeerTimeoutError is fleet.PeerTimeoutError
    err = fleet.PeerTimeoutError("collective 'x' missing rank(s): [1]",
                                 collective="x", suspects=(1,))
    assert isinstance(err, RuntimeError)
    assert classify_exception(err) == "retryable"
    assert classify_child(1, "g2vec_tpu_torch.resilience.fleet."
                             "PeerTimeoutError: collective 'x' missing "
                             "rank(s): [1]") == "retryable"


def test_store_collective_notes_its_entry_and_names_the_phase(
        tmp_path, monkeypatch):
    """This process as rank 0 of two over a real store, rank 1's liveness
    file stale in ``train``: the allgather records (name, seq) in rank
    0's file before it waits, and its timeout names rank 1's phase and
    last collective."""
    import datetime

    from torch.distributed import TCPStore

    from g2vec_tpu_torch.parallel import distributed

    store = TCPStore("127.0.0.1", 0, 2, True,
                     timeout=datetime.timedelta(seconds=30),
                     wait_for_workers=False)
    monkeypatch.setattr(distributed, "_world", distributed._World(
        0, 2, "127.0.0.1", store.port, store))
    monkeypatch.setenv("G2VEC_PROCESS_ID", "0")
    d = str(tmp_path)
    fleet.configure(liveness_dir=d, heartbeat_interval=5.0)
    fleet.start_heartbeat()
    with open(fleet.liveness_path(d, 1), "w") as f:
        json.dump({"rank": 1, "ts": time.time() - 60.0, "beats": 3,
                   "phase": "train", "collective": "stage/paths",
                   "collective_seq": 6}, f)
    with pytest.raises(fleet.PeerTimeoutError) as ei:
        hostcomm.allgather_bytes("h_unit", b"x", deadline=0.3)
    me = fleet.read_liveness(d, 0)
    assert me["collective"] == "h_unit" and me["collective_seq"] >= 0
    msg = str(ei.value)
    assert "missing rank(s): [1]" in msg
    assert "rank 1: heartbeat stale" in msg and "phase='train'" in msg
    assert "last collective='stage/paths' seq 6" in msg


# ---------------------------------------------------------------------------
# The CLI on the CPU
# ---------------------------------------------------------------------------

_FLAGS = ["-p", "20", "-r", "3", "-s", "16", "-e", "12", "-l", "0.002",
          "-n", "10", "--device", "cpu", "--sampler-threads", "2"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The ``small`` spec's files (make_example's CLI) and the port's
    single-process run of them at the drills' flags."""
    from g2vec_tpu_torch.config import config_from_args
    from g2vec_tpu_torch.pipeline import run

    tmp = tmp_path_factory.mktemp("fleet")
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch.data.make_example",
         str(tmp), "--scale", "small"], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    files = [str(tmp / f"syn_{k}.txt")
             for k in ("EXPRESSION", "CLINICAL", "NETWORK")]
    solo = run(config_from_args([*files, str(tmp / "solo"), *_FLAGS]),
               console=lambda s: None)
    outputs = []
    for path in solo.output_files:
        with open(path, "rb") as f:
            outputs.append(f.read())
    return dict(tmp=tmp, files=files, outputs=outputs)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("G2VEC_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(extra)
    return env


def _schemas():
    with open(os.path.join(ROOT, "g2vec_tpu", "utils",
                           "metrics_schema.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "EVENT_SCHEMAS"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("EVENT_SCHEMAS not found")


def test_fleet_loses_rank_1_replans_and_writes_the_solo_bytes(small):
    tmp = small["tmp"]
    metrics = str(tmp / "fleet.jsonl")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch", *small["files"],
         str(tmp / "fleet"), *_FLAGS, "--fleet-size", "2",
         "--checkpoint-dir", str(tmp / "ck"), "--checkpoint-layout",
         "sharded", "--checkpoint-every", "2", "--fleet-liveness-dir",
         str(tmp / "L"), "--fleet-watchdog-deadline", "3",
         "--fleet-heartbeat-interval", "0.2", "--metrics-jsonl", metrics,
         "--supervise-backoff", "0", "--fault-plan",
         "process=1,stage=checkpoint_finalize,epoch=2,kind=sigkill"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert time.time() - t0 < 120
    assert "re-planning mesh 2x1 -> 1x1 over 1 rank(s)" in proc.stderr
    for suffix, want in zip(("biomarkers", "lgroups", "vectors"),
                            small["outputs"]):
        with open(f"{tmp / 'fleet'}_{suffix}.txt", "rb") as f:
            assert f.read() == want, suffix
    with open(metrics) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    names = [e["event"] for e in events]
    for name in ("fleet_peer_death", "fleet_replan", "fleet_launch",
                 "fleet_done", "heartbeat", "done"):
        assert name in names, name
    death = events[names.index("fleet_peer_death")]
    assert death["dead_ranks"] == [1] and death["classified"] == "retryable"
    assert death["returncodes"] == {"0": 1, "1": -9}
    replan = events[names.index("fleet_replan")]
    assert (replan["old_mesh"], replan["new_mesh"],
            replan["surviving_ranks"]) == ([2, 1], [1, 1], 1)
    relaunch = events[names.index("fleet_launch")]
    assert relaunch["resume"] is True and relaunch["ranks"] == 1
    assert events[names.index("fleet_done")]["attempts"] == 2
    # The resumed attempt trained only what the checkpoint had not.
    assert names.index("fleet_replan") < names.index("done")
    schemas = _schemas()
    for e in events:
        spec = schemas[e["event"]]
        keys = set(e) - {"seq", "ts", "event"}
        assert set(spec["required"]) <= keys, e
        if spec["required"] or spec["optional"]:
            assert keys <= set(spec["required"]) | set(spec["optional"]), e
    # Rank 0's first attempt died of the timeout that named rank 1.
    with open(tmp / "L" / "logs-attempt0" / "rank0.err") as f:
        assert "missing rank(s): [1]" in f.read()


def test_a_sigkilled_rank_is_named_by_its_peer(small):
    tmp = small["tmp"]
    live = str(tmp / "L2")
    argv = [sys.executable, "-m", "g2vec_tpu_torch", *small["files"],
            str(tmp / "drill"), *_FLAGS, "--distributed", "--mesh", "2x1",
            "--fleet-watchdog-deadline", "3", "--fleet-liveness-dir", live,
            "--fleet-heartbeat-interval", "0.2", "--fault-plan",
            "process=1,stage=train,epoch=2,kind=sigkill"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(argv, env=_env(
        G2VEC_COORDINATOR=f"127.0.0.1:{port}", G2VEC_PROCESS_ID=str(r),
        G2VEC_NUM_PROCESSES="2"), cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == -9
    assert procs[0].returncode == 1
    err = outs[0][1]
    assert "PeerTimeoutError" in err and "missing rank(s): [1]" in err
    assert "collective 'stage/train'" in err
    assert "rank 1: heartbeat" in err and "phase='train'" in err
    assert "last collective='stage/paths'" in err
