"""The port's fault plan and supervisor against ``g2vec_tpu.resilience``.

- The JAX package's plan specs (tests/test_resilience.py), accepted and
  rejected, on the port's parser; a seam of the JAX package that the port
  does not call is refused at install time, not silently never fired.
- The fault kinds, the epoch gate, ``skip``, ``times``, ``process`` and
  the cross-restart state file.
- The classification table, with the card's own cases: an out-of-memory
  (``torch.cuda.OutOfMemoryError``) is retryable; a sticky CUDA error is
  fatal in process (the context is broken) and retryable in child mode.
- The supervisor on the port's pipeline at a small size on the CPU: it
  recovers from a stage crash and from a train-loop crash with outputs
  byte-identical to an uninterrupted run, gives up on ``fatal`` and on a
  sticky CUDA error, spends its budget, and survives a corrupt latest
  checkpoint; ``checkpoint_write`` crashes before the write;
  ``native_load`` and ``native_walker_load`` degrade. One child-mode
  ``--supervise`` run is SIGKILLed in training and resumes to the
  uninterrupted run's bytes, with no jax in the child's ``sys.modules``
  and no torch in the supervisor's.
- Every seam of the port's registry has a call site in the port and a
  test that names it.
"""
import ast
import glob
import json
import os
import re
import stat
import subprocess
import sys

import pytest
import torch

from g2vec_tpu.resilience import faults as jfaults
from g2vec_tpu_torch.config import G2VecConfig, config_from_args
from g2vec_tpu_torch.resilience import faults
from g2vec_tpu_torch.resilience.supervisor import (RetryPolicy,
                                                   _scrub_supervisor_argv,
                                                   classify_child,
                                                   classify_exception,
                                                   supervise)

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """Fault state is process-global: every test starts and ends clean."""
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    faults._reset_for_tests()
    yield
    faults._reset_for_tests()


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,match", [
    ("stage=nonsense", "seam"),
    ("stage=train,kind=explode", "kind"),
    ("stage=train,when=now", "key"),
    ("kind=crash", "stage"),
    ("stage=train,epoch=soon", "non-numeric"),
    ("stage", "not key=value"),
])
def test_plan_rejects_bad_specs(spec, match):
    with pytest.raises(faults.FaultPlanError, match=match):
        faults.parse_plan(spec)
    with pytest.raises(jfaults.FaultPlanError, match=match):
        jfaults.parse_plan(spec)


@pytest.mark.parametrize("seam", ["stage_barrier", "heartbeat"])
def test_reference_seam_the_port_lacks_is_refused(seam):
    """The fleet's two seams were the last the port lacked; a plan naming
    one is now accepted by both packages and fires."""
    jfaults.parse_plan(f"stage={seam},kind=crash")      # the JAX package's
    faults.install_plan(f"stage={seam},kind=crash")
    G2VecConfig(fault_plan=f"stage=load;stage={seam}").validate()
    with pytest.raises(faults.InjectedFault, match=f"seam={seam}"):
        faults.fault_point(seam)


@pytest.mark.parametrize("kind", ["crash", "fatal"])
def test_update_publish_fires_between_the_rename_and_the_pointer_flip(
        kind, tmp_path):
    """The ``update_publish`` seam, in both packages' writers: the new
    generation is renamed in and the pointer still names the prior one;
    the next publication goes past the orphan's serial."""
    import numpy as np

    from g2vec_tpu.io import writers as jwriters
    from g2vec_tpu_torch.io import writers

    emb = np.random.default_rng(0).standard_normal((6, 4)).astype(
        np.float32)
    genes = [f"G{i}" for i in range(6)]
    states = []
    for mod, fmod, sub in ((writers, faults, "port"),
                           (jwriters, jfaults, "jax")):
        root = str(tmp_path / sub)
        mod.write_inventory_bundle(root, emb, genes, None, {})
        fmod.install_plan(f"stage=update_publish,kind={kind}")
        err = fmod.InjectedFatal if kind == "fatal" else \
            fmod.InjectedFault
        with pytest.raises(err):
            mod.write_inventory_bundle(root, emb, genes, None, {})
        fmod._reset_for_tests()
        after = (mod.read_generation(root), sorted(os.listdir(root)))
        last = mod.write_inventory_bundle(root, emb, genes, None, {})
        states.append((after, os.path.basename(last),
                       mod.read_generation(root)))
    assert states[0] == states[1]
    (pointer, listing), last, live = states[0]
    assert pointer == "gen-000001"
    assert "gen-000002" in listing
    assert last == live == "gen-000003"


def test_registry_is_the_reference_split_in_two():
    assert set(faults.SEAMS) == set(jfaults.SEAMS)
    assert len(faults.SEAMS) == len(set(faults.SEAMS))
    assert not hasattr(faults, "NOT_PORTED")
    assert faults.KINDS == jfaults.KINDS
    assert (faults.ENV_PLAN, faults.ENV_STATE) == (jfaults.ENV_PLAN,
                                                   jfaults.ENV_STATE)


def test_plan_parses_as_the_reference_does():
    spec = ("stage=train,epoch=40,kind=crash; stage=save,kind=sigkill,"
            "times=2; stage=prefetch,kind=stall,seconds=0.5,skip=3,"
            "process=1")
    got = [(e.stage, e.epoch, e.kind, e.times, e.skip, e.seconds, e.process)
           for e in faults.parse_plan(spec)]
    want = [(e.stage, e.epoch, e.kind, e.times, e.skip, e.seconds, e.process)
            for e in jfaults.parse_plan(spec)]
    assert got == want and got[0] == ("train", 40, "crash", 1, 0, 300.0,
                                      None)
    with pytest.raises(ValueError, match="seam"):
        G2VecConfig(fault_plan="stage=nope").validate()


def test_fault_point_is_noop_without_plan():
    faults.fault_point("load")
    faults.fault_point("train", epoch=5)


def test_crash_fires_once_and_epoch_gates():
    faults.install_plan("stage=train,epoch=10,kind=crash")
    faults.fault_point("train", epoch=9)          # below the gate
    faults.fault_point("train")                    # no epoch: gated out
    with pytest.raises(faults.InjectedFault, match="seam=train epoch=10"):
        faults.fault_point("train", epoch=10)
    faults.fault_point("train", epoch=11)         # already fired


@pytest.mark.parametrize("kind,exc", [("stall", faults.InjectedFault),
                                      ("fatal", faults.InjectedFatal),
                                      ("crash", faults.InjectedFault)])
def test_kinds_raise(kind, exc):
    faults.install_plan(f"stage=paths,kind={kind},seconds=0")
    with pytest.raises(exc, match=kind if kind != "fatal" else "fatal"):
        faults.fault_point("paths")


def test_skip_and_times():
    faults.install_plan("stage=save,kind=crash,skip=2,times=2")
    faults.fault_point("save")
    faults.fault_point("save")
    for _ in range(2):
        with pytest.raises(faults.InjectedFault):
            faults.fault_point("save")
    faults.fault_point("save")                     # times spent


def test_process_scoping_reads_the_rank_from_the_environment(monkeypatch):
    faults.install_plan("process=1,stage=load,kind=crash")
    faults.fault_point("load")                     # rank 0: not fired
    monkeypatch.setenv("G2VEC_PROCESS_ID", "1")
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("load")


def test_corrupt_flips_bytes_and_needs_a_path(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(range(256)))
    faults.install_plan("stage=checkpoint_finalize,kind=corrupt,times=2")
    faults.fault_point("checkpoint_finalize", path=str(path))
    data = path.read_bytes()
    assert len(data) == 256 and data != bytes(range(256))
    with pytest.raises(faults.InjectedFault, match="needs a seam"):
        faults.fault_point("checkpoint_finalize")


def test_state_file_persists_fired_entries(tmp_path, monkeypatch):
    state = str(tmp_path / "fault-state.json")
    monkeypatch.setenv(faults.ENV_STATE, state)
    faults.install_plan("stage=load,kind=crash")
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("load")
    faults._reset_for_tests()        # a "restarted process"
    faults.install_plan("stage=load,kind=crash")
    faults.fault_point("load")       # the fired state is honored
    assert json.load(open(state)) == {"load:None:crash": 1}


def test_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv(faults.ENV_PLAN, "stage=walk_cache,kind=fatal")
    with pytest.raises(faults.InjectedFatal):
        faults.fault_point("walk_cache")


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

_STICKY = "CUDA error: an illegal memory access was encountered"


@pytest.mark.parametrize("exc,verdict", [
    (faults.InjectedFault("x"), "retryable"),
    (faults.InjectedFatal("x"), "fatal"),
    (RuntimeError("preempted"), "retryable"),
    (MemoryError(), "retryable"),
    (OSError("io wobble"), "retryable"),
    (ValueError("label must be 0 or 1"), "fatal"),
    (ValueError("RESOURCE_EXHAUSTED: hbm oom"), "retryable"),
    (FileNotFoundError("gone"), "fatal"),
    (TypeError("bad arg"), "fatal"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "retryable"),
    (RuntimeError("CUDA error: out of memory"), "retryable"),
    (RuntimeError(_STICKY), "fatal"),
    (RuntimeError("cudaErrorLaunchFailure: unspecified launch failure"),
     "fatal"),
    (RuntimeError("kernel failed: an illegal memory access"), "fatal"),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else v)
def test_classification_table(exc, verdict):
    assert classify_exception(exc) == verdict


@pytest.mark.parametrize("rc,tail,verdict", [
    (-9, "", "retryable"),                               # SIGKILL
    (1, "ValueError: bad label", "fatal"),
    (1, "RuntimeError: preempted", "retryable"),
    (1, "InjectedFault: injected crash", "retryable"),
    (1, "", "retryable"),
    (1, f"RuntimeError: {_STICKY}", "retryable"),        # a fresh process
    (1, "torch.OutOfMemoryError: CUDA out of memory", "retryable"),
])
def test_child_classification(rc, tail, verdict):
    assert classify_child(rc, tail) == verdict


def test_scrub_supervisor_argv():
    argv = ["e", "c", "n", "r", "--supervise", "--supervise-retries", "5",
            "--supervise-backoff=0.1", "--seed", "3"]
    assert _scrub_supervisor_argv(argv) == ["e", "c", "n", "r", "--seed", "3"]


def test_metrics_writer_append_mode(tmp_path):
    from g2vec_tpu_torch.utils.metrics import MetricsWriter

    path = str(tmp_path / "m.jsonl")
    with MetricsWriter(path) as m:
        m.emit("a")
    with MetricsWriter(path, append=True) as m:
        m.emit("b")
    assert [e["event"] for e in _read_events(path)] == ["a", "b"]
    with MetricsWriter(path) as m:      # default mode truncates
        m.emit("c")
    assert [e["event"] for e in _read_events(path)] == ["c"]


def test_cli_flags_and_validation():
    cfg = config_from_args(
        ["e", "c", "n", "r", "--checkpoint-dir", "d", "--checkpoint-every",
         "4", "--resume", "--supervise", "--supervise-retries", "2",
         "--supervise-backoff", "0.5", "--fault-plan", "stage=train"])
    assert (cfg.checkpoint_dir, cfg.checkpoint_every, cfg.resume,
            cfg.supervise, cfg.supervise_retries, cfg.supervise_backoff,
            cfg.fault_plan) == ("d", 4, True, True, 2, 0.5, "stage=train")
    # Two layouts, as in the reference; argparse refuses any other.
    for layout in ("single", "sharded"):
        assert config_from_args(["e", "c", "n", "r", "--checkpoint-layout",
                                 layout]).checkpoint_layout == layout
    with pytest.raises(SystemExit):
        config_from_args(["e", "c", "n", "r", "--checkpoint-layout",
                          "ocdbt"])
    for over, match in ((dict(checkpoint_every=0), "checkpoint_every"),
                        (dict(supervise_retries=-1), "supervise_retries"),
                        (dict(supervise_backoff=-0.5), "supervise_backoff"),
                        (dict(train_mode="streaming", resume=True),
                         "--checkpoint-dir")):
        with pytest.raises(ValueError, match=match):
            G2VecConfig(**over).validate()


# ---------------------------------------------------------------------------
# The supervisor on the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tsv_paths(tmp_path_factory):
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)

    spec = SyntheticSpec(n_good=24, n_poor=20, module_size=12,
                         n_background=24, n_expr_only=4, n_net_only=4,
                         module_chords=2, background_edges=40, seed=7)
    return write_synthetic_tsv(spec, str(tmp_path_factory.mktemp("syn")))


def _cfg(tsv_paths, tmp_path, **overrides):
    defaults = dict(
        expression_file=tsv_paths["expression"],
        clinical_file=tsv_paths["clinical"],
        network_file=tsv_paths["network"],
        result_name=os.path.join(str(tmp_path), "out"),
        lenPath=8, numRepetition=2, sizeHiddenlayer=16, epoch=30,
        learningRate=0.002, numBiomarker=5, compute_dtype="float32",
        kmeans_iters=50, seed=0, device="cpu")
    defaults.update(overrides)
    return G2VecConfig(**defaults)


_FAST = RetryPolicy(max_retries=3, backoff_base=0.0, backoff_max=0.0,
                    jitter=0.0)
_quiet = lambda s: None  # noqa: E731
_nosleep = lambda s: None  # noqa: E731


def _read_events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _outputs(result_name):
    out = []
    for suffix in ("_biomarkers.txt", "_lgroups.txt", "_vectors.txt"):
        with open(result_name + suffix, "rb") as f:
            out.append(f.read())
    return out


@pytest.fixture(scope="module")
def clean(tsv_paths, tmp_path_factory):
    """The uninterrupted checkpointed run every drill is held against."""
    from g2vec_tpu_torch.pipeline import run

    tmp = tmp_path_factory.mktemp("clean")
    res = run(_cfg(tsv_paths, tmp, checkpoint_dir=str(tmp / "ck"),
                   checkpoint_every=3), console=_quiet)
    assert len(res.train_history) >= 8, "the config trains too briefly"
    return _outputs(str(tmp / "out")), res


@pytest.mark.parametrize("stage", ["load", "preprocess", "paths", "train",
                                   "lgroups", "biomarkers", "save"])
def test_supervised_recovers_from_stage_crash(tsv_paths, tmp_path, clean,
                                              stage):
    mj = str(tmp_path / "m.jsonl")
    cfg = _cfg(tsv_paths, tmp_path, metrics_jsonl=mj,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
               fault_plan=f"stage={stage},kind=crash")
    supervise(cfg, policy=_FAST, console=_quiet, sleep=_nosleep)
    assert _outputs(cfg.result_name) == clean[0]
    events = _read_events(mj)
    names = [e["event"] for e in events]
    assert {"retry", "resume", "supervised_done", "done"} <= set(names)
    retry = next(e for e in events if e["event"] == "retry")
    assert retry["classified"] == "retryable"
    assert f"injected crash at seam={stage}" in retry["error"]
    # A crash after training resumes a finished run: nothing retrains.
    idx = names.index("resume")
    resumed = [e["step"] for e in events[idx + 1:] if e["event"] == "epoch"]
    if stage in ("lgroups", "biomarkers", "save"):
        assert resumed == []


def test_supervised_recovers_from_train_loop_crash(tsv_paths, tmp_path,
                                                   clean):
    """The retry resumes from the last checkpoint (epochs before it are
    not redone) and writes the uninterrupted run's bytes."""
    mj = str(tmp_path / "m.jsonl")
    cfg = _cfg(tsv_paths, tmp_path, metrics_jsonl=mj,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
               fault_plan="stage=train,epoch=6,kind=crash")
    supervise(cfg, policy=_FAST, console=_quiet, sleep=_nosleep)
    assert _outputs(cfg.result_name) == clean[0]
    events = _read_events(mj)
    assert [e["event"] for e in events].count("retry") == 1
    idx = [e["event"] for e in events].index("resume")
    resumed = [e["step"] for e in events[idx + 1:] if e["event"] == "epoch"]
    assert resumed and resumed[0] == 6            # checkpoint at epoch 5


def test_supervised_survives_corrupt_latest_checkpoint(tsv_paths, tmp_path,
                                                       clean):
    """skip=1: the second save (epoch 5) is torn; the crash at epoch 6
    resumes from the verified epoch-2 generation, with a warning."""
    mj = str(tmp_path / "m.jsonl")
    cfg = _cfg(tsv_paths, tmp_path, metrics_jsonl=mj,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
               fault_plan="stage=checkpoint_finalize,kind=corrupt,skip=1;"
                          "stage=train,epoch=6,kind=crash")
    with pytest.warns(RuntimeWarning, match="integrity"):
        supervise(cfg, policy=_FAST, console=_quiet, sleep=_nosleep)
    assert _outputs(cfg.result_name) == clean[0]
    events = _read_events(mj)
    idx = [e["event"] for e in events].index("resume")
    resumed = [e["step"] for e in events[idx + 1:] if e["event"] == "epoch"]
    assert resumed and resumed[0] == 3            # .prev: epoch 2


def test_supervisor_gives_up_on_fatal(tsv_paths, tmp_path):
    mj = str(tmp_path / "m.jsonl")
    cfg = _cfg(tsv_paths, tmp_path, metrics_jsonl=mj,
               fault_plan="stage=preprocess,kind=fatal")
    with pytest.raises(faults.InjectedFatal):
        supervise(cfg, policy=_FAST, console=_quiet, sleep=_nosleep)
    events = [e["event"] for e in _read_events(mj)]
    assert "gave_up" in events and "retry" not in events


def test_supervisor_exhausts_retry_budget(tsv_paths, tmp_path):
    mj = str(tmp_path / "m.jsonl")
    cfg = _cfg(tsv_paths, tmp_path, metrics_jsonl=mj,
               fault_plan="stage=load,kind=crash,times=99")
    policy = RetryPolicy(max_retries=2, backoff_base=0.0, backoff_max=0.0,
                         jitter=0.0)
    with pytest.raises(faults.InjectedFault):
        supervise(cfg, policy=policy, console=_quiet, sleep=_nosleep)
    events = [e["event"] for e in _read_events(mj)]
    assert events.count("retry") == 2 and "gave_up" in events


def test_sticky_cuda_error_is_fatal_in_process(tsv_paths, tmp_path,
                                               monkeypatch):
    """A CUDA error leaves the context broken: no in-process retry, and
    the message points to --supervise."""
    from g2vec_tpu_torch import pipeline

    def broken(*a, **k):
        raise RuntimeError(_STICKY)

    monkeypatch.setattr(pipeline, "preprocess_inputs", broken)
    mj = str(tmp_path / "m.jsonl")
    lines = []
    with pytest.raises(RuntimeError, match="illegal memory access"):
        supervise(_cfg(tsv_paths, tmp_path, metrics_jsonl=mj),
                  policy=_FAST, console=lines.append, sleep=_nosleep)
    events = _read_events(mj)
    assert [e["event"] for e in events if e["event"] in
            ("retry", "gave_up")] == ["gave_up"]
    assert events[-1]["classified"] == "fatal"
    assert "--supervise" in events[-1]["error"]
    assert "--supervise" in lines[-1]


def test_checkpoint_write_fault_crashes_before_write(tmp_path):
    """A crash at ``checkpoint_write`` leaves no partial checkpoint, and
    the prior generation survives for the resume."""
    from g2vec_tpu_torch.train import checkpoint as ck

    d = str(tmp_path)
    p = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
         torch.zeros(3, 1)]
    opt = (1, p, p)
    ck.save_state(d, p, opt, p, 4, 0.5, 0.6)
    faults.install_plan("stage=checkpoint_write,kind=crash")
    with pytest.raises(faults.InjectedFault):
        ck.save_state(d, p, opt, p, 9, 0.7, 0.8)
    assert not glob.glob(os.path.join(d, "*.tmp*"))   # no torn write
    assert not os.path.exists(os.path.join(d, ck.CKPT_NAME + ck.PREV_SUFFIX))
    assert ck.load_state(d, p, opt)[3] == 4


def test_native_load_faults_degrade_not_die(tsv_paths, tmp_path):
    """Both readers fall back to Python (one warning) and the auto walker
    resolves to the card's walker (its plain version here); the run
    completes with the bytes of a run that pinned both."""
    from g2vec_tpu_torch.io import readers
    from g2vec_tpu_torch.ops.backend import resolve_walker_backend
    from g2vec_tpu_torch.pipeline import run

    pinned = run(_cfg(tsv_paths, tmp_path, result_name=str(tmp_path / "a"),
                      use_native_io=False, walker_backend="device"),
                 console=_quiet)
    cfg = _cfg(tsv_paths, tmp_path, result_name=str(tmp_path / "b"),
               walker_backend="auto",
               fault_plan="stage=native_load,kind=crash,times=2;"
                          "stage=native_walker_load,kind=crash")
    faults.install_plan(cfg.fault_plan)
    assert resolve_walker_backend(cfg) == "device"
    faults._reset_for_tests()
    readers._warned_native = False
    with pytest.warns(RuntimeWarning, match="native TSV reader unavailable"):
        degraded = run(cfg, console=_quiet)
    assert degraded.walker_backend == "device"
    for parser in ("expression_parser", "network_parser"):
        assert degraded.stage_extras["load"][parser] == "python"
        assert pinned.stage_extras["load"][parser] == "python"
    assert _outputs(str(tmp_path / "b")) == _outputs(str(tmp_path / "a"))
    assert pinned.walker_backend == "device"


# ---------------------------------------------------------------------------
# --supervise in child mode: a SIGKILL mid-training
# ---------------------------------------------------------------------------

_CHILD = r"""
import atexit, json, os, runpy, sys
assert sys.argv[1:3] == ["-m", "g2vec_tpu_torch"], sys.argv
sys.argv = ["g2vec_tpu_torch", *sys.argv[3:]]

def report():
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                        "g2vec_tpu", "ml_dtypes"))
    with open(os.path.join(os.environ["CHILD_REPORTS"],
                           f"{os.getpid()}.json"), "w") as f:
        json.dump(bad, f)

atexit.register(report)
runpy.run_module("g2vec_tpu_torch", run_name="__main__")
"""

_SUPERVISOR = r"""
import json, sys
sys.executable = sys.argv[1]          # the children run through the wrapper
from g2vec_tpu_torch.__main__ import main
rc = main(sys.argv[2:])
print(json.dumps({"rc": rc, "torch": "torch" in sys.modules,
                  "jax": "jax" in sys.modules}))
"""


def test_child_mode_sigkill_resumes_bit_identical(tsv_paths, tmp_path,
                                                  clean):
    (tmp_path / "reports").mkdir()
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    wrapper = tmp_path / "python-child"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {child} \"$@\"\n")
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IEXEC)
    mj = str(tmp_path / "m.jsonl")
    state = str(tmp_path / "fault-state.json")
    out = str(tmp_path / "b")
    argv = [tsv_paths["expression"], tsv_paths["clinical"],
            tsv_paths["network"], out, "-p", "8", "-r", "2", "-s", "16",
            "-e", "30", "-l", "0.002", "-n", "5", "--seed", "0",
            "--compute-dtype", "float32", "--kmeans-iters", "50",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "3", "--metrics-jsonl", mj,
            "--supervise", "--supervise-backoff", "0",
            "--fault-plan", "stage=train,epoch=6,kind=sigkill"]
    env = dict(os.environ, PYTHONPATH=ROOT, CHILD_REPORTS=str(
        tmp_path / "reports"), G2VEC_FAULT_STATE=state)
    env.pop(faults.ENV_PLAN, None)
    proc = subprocess.run(
        [sys.executable, "-c", _SUPERVISOR, str(wrapper), *argv],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "torch": False, "jax": False}
    assert "[supervisor] attempt 0 failed (rc=-9)" in proc.stderr
    assert _outputs(out) == clean[0]
    assert json.load(open(state)) == {"train:6:sigkill": 1}
    events = _read_events(mj)
    names = [e["event"] for e in events]
    assert {"retry", "resume", "supervised_done"} <= set(names)
    assert names.count("done") == 1
    idx = names.index("resume")
    resumed = [e["step"] for e in events[idx + 1:] if e["event"] == "epoch"]
    assert resumed and resumed[0] == 6
    # The killed child wrote no report; the resumed one imported no jax.
    reports = [json.load(open(p))
               for p in glob.glob(str(tmp_path / "reports" / "*.json"))]
    assert reports == [[]]


# ---------------------------------------------------------------------------
# The registry against the call sites and the tests
# ---------------------------------------------------------------------------

def _port_call_sites():
    sites = {}
    for path in glob.glob(os.path.join(ROOT, "g2vec_tpu_torch", "**",
                                       "*.py"), recursive=True):
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", None)) \
                    == "fault_point":
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), \
                    f"{path}:{node.lineno}: seam is not a string literal"
                sites.setdefault(arg.value, []).append(
                    f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    return sites


def test_every_seam_has_a_call_site_and_a_test():
    sites = _port_call_sites()
    assert set(sites) == set(faults.SEAMS), sites
    assert set(sites) <= set(jfaults.SEAMS)
    tests_text = "\n".join(open(p).read() for p in glob.glob(
        os.path.join(ROOT, "tests", "test_torch_*.py")))
    untested = [s for s in faults.SEAMS
                if not re.search(r"\b%s\b" % re.escape(s), tests_text)]
    assert not untested, f"seams no port test names: {untested}"


# ---------------------------------------------------------------------------
# The sharded run's seams, each at its call site
# ---------------------------------------------------------------------------

@pytest.fixture
def two_rank_world(monkeypatch):
    """This process as rank 0 of two, over a real store (no peer joins: a
    seam that fires before its collective needs none)."""
    import datetime

    from torch.distributed import TCPStore

    from g2vec_tpu_torch.parallel import distributed

    store = TCPStore("127.0.0.1", 0, 2, True,
                     timeout=datetime.timedelta(seconds=30),
                     wait_for_workers=False)
    monkeypatch.setattr(distributed, "_world", distributed._World(
        0, 2, "127.0.0.1", store.port, store))
    return store


def _split_run(spec_kw):
    import numpy as np

    from g2vec_tpu_torch.parallel.shard import ShardContext, ShardSpec
    from g2vec_tpu_torch.train.stream import train_cbow_streaming

    rng = np.random.default_rng(0)
    groups = []
    for _ in range(2):
        src = rng.integers(0, 40, 120)
        dst = (src + 1 + rng.integers(0, 39, 120)) % 40
        groups.append((src, dst, rng.random(120).astype(np.float32) + 0.5))
    ctx = ShardContext(ShardSpec(rank=0, n_ranks=2, n_genes=40, **spec_kw),
                       deadline=5.0)
    return train_cbow_streaming(
        groups=groups, n_genes=40, genes=[f"G{i}" for i in range(40)],
        hidden=8, learning_rate=0.01, max_epochs=2, len_path=6, reps=2,
        shard_paths=16, compute_dtype="float32", device="cpu",
        shard_ctx=ctx)


@pytest.mark.parametrize("seam", ["allgather", "shard_exchange",
                                  "embed_allreduce"])
def test_sharded_seam_fires_at_its_call_site(seam, two_rank_world):
    """The three seams the sharded run brought out of NOT_PORTED: a crash
    there raises where the seam stands, before anything is published."""
    from g2vec_tpu_torch.parallel import hostcomm

    faults.install_plan(f"stage={seam},kind=crash")
    with pytest.raises(faults.InjectedFault, match=f"seam={seam}"):
        if seam == "allgather":
            hostcomm.allgather_bytes("h_step", b"payload", deadline=1.0)
        elif seam == "shard_exchange":
            # Rank 0 owns the first partition's shards: it walks shard 0,
            # and the seam fires between the walk and the publish.
            _split_run(dict(graph_shards=2))
        else:
            # The first split step, before its allreduce.
            _split_run(dict(embed_shards=2))
    published = [k for k in ("g2vec/xc/walk/0/n",)
                 if two_rank_world.check([k])]
    assert published == []
    assert not two_rank_world.check(["g2vec/ag/0/h_step/0"])
