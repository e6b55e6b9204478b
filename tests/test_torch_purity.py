"""The port stands alone: no JAX, nothing of g2vec_tpu, no CPU fallback.

- By AST: no module of g2vec_tpu_torch/, and not chip_smoke.py, imports
  jax, jaxlib, optax, ml_dtypes or g2vec_tpu.
- At run time: the port's CLI (``python -m g2vec_tpu_torch ... --device
  cpu``, full-batch, ``--train-mode streaming`` plain and under
  ``--distributed --graph-shards 1 --embed-shards 1 --walk-starts``,
  ``--distributed --mesh 1x1`` with the sharded checkpoint layout,
  ``--seeds`` and
  ``--scenario``) runs a tiny spec end to end in a fresh interpreter,
  after which neither jax nor any g2vec_tpu module is in ``sys.modules``;
  so do ``serve --help`` and the router serving a job through a replica
  (both load no torch either), the serve daemon serving a job, and the
  daemon serving an ``update`` of a bundle.
- The ``--fleet-size`` launcher imports no torch; its ranks run the CLI.
- Without ``--device cpu`` on a machine with no card, the entry points
  raise instead of running on the CPU.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "ml_dtypes", "g2vec_tpu"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "g2vec_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_or_reference(path):
    bad = [(ln, name) for ln, name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


_CLI_SCRIPT = r"""
import json, runpy, sys
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
out_dir = sys.argv[1]
files = write_synthetic_tsv(SyntheticSpec(
    n_good=12, n_poor=10, module_size=8, n_background=10, n_expr_only=2,
    n_net_only=2, module_chords=2, background_edges=15, seed=3), out_dir)
sys.argv = ["g2vec_tpu_torch", files["expression"], files["clinical"],
            files["network"], out_dir + "/tiny", "-p", "10", "-r", "3",
            "-s", "8", "-e", "4", "-n", "5", "--kmeans-iters", "20",
            "--device", "cpu", *sys.argv[2:]]
rc = None
try:
    runpy.run_module("g2vec_tpu_torch", run_name="__main__")
except SystemExit as e:
    rc = e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes",
                                    "g2vec_tpu"))
print(json.dumps({"rc": rc, "bad": bad}))
"""


def _run_cli(tmp_path, *extra, names=("tiny",),
             last_stage=">>> 7. Save results"):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CLI_SCRIPT, str(tmp_path),
                           *extra],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert last_stage in lines
    report = json.loads(lines[-1])
    assert report == {"rc": 0, "bad": []}
    for name in names:
        for suffix in ("biomarkers", "lgroups", "vectors"):
            assert (tmp_path / f"{name}_{suffix}.txt").exists()
    return lines


def test_cli_runs_without_jax_in_sys_modules(tmp_path):
    _run_cli(tmp_path)


def test_streaming_cli_runs_without_jax_in_sys_modules(tmp_path):
    """The streaming trainer, the overlap scheduler, the native reader and
    the metrics stream are all on this run's path."""
    lines = _run_cli(tmp_path, "--train-mode", "streaming", "--shard-paths",
                     "16", "--metrics-jsonl", str(tmp_path / "m.jsonl"))
    assert any("(streamed, " in line for line in lines)
    events = [json.loads(line)["event"]
              for line in open(tmp_path / "m.jsonl")]
    assert "stream" in events and events[-1] == "done"


def test_sharded_streaming_cli_runs_without_jax_in_sys_modules(tmp_path):
    """The sharded run's modules (the shard context, the store transport,
    the distributed runtime, the split step's module) are imported on this
    path: one rank under --distributed with both axes and --walk-starts."""
    lines = _run_cli(tmp_path, "--train-mode", "streaming", "--shard-paths",
                     "16", "--distributed", "--graph-shards", "1",
                     "--embed-shards", "1", "--walk-starts", "12",
                     "--fleet-watchdog-deadline", "30")
    assert any(line.startswith("    [shard] rank 0/1: graph_shards=1 "
                               "embed_shards=1") for line in lines)


def test_mesh_cli_runs_without_jax_in_sys_modules(tmp_path):
    """The fleet, the mesh context, the mesh half of the runtime and the
    sharded checkpoint layout are on this run's path: one rank under
    --distributed --mesh 1x1 with the liveness flags."""
    _run_cli(tmp_path, "--distributed", "--mesh", "1x1", "--checkpoint-dir",
             str(tmp_path / "ck"), "--checkpoint-layout", "sharded",
             "--fleet-liveness-dir", str(tmp_path / "L"),
             "--fleet-watchdog-deadline", "30")
    assert (tmp_path / "L" / "rank_0.json").exists()
    assert any(n.startswith("cbow_state_sharded.")
               for n in os.listdir(tmp_path / "ck"))


_LAUNCHER_SCRIPT = r"""
import json, sys
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.__main__ import main
out_dir = sys.argv[1]
files = write_synthetic_tsv(SyntheticSpec(
    n_good=12, n_poor=10, module_size=8, n_background=10, n_expr_only=2,
    n_net_only=2, module_chords=2, background_edges=15, seed=3), out_dir)
rc = main([files["expression"], files["clinical"], files["network"],
           out_dir + "/tiny", "-p", "10", "-r", "3", "-s", "8", "-e", "4",
           "-n", "5", "--kmeans-iters", "20", "--device", "cpu",
           "--fleet-size", "2", "--sampler-threads", "1"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "g2vec_tpu"))
print(json.dumps({"rc": rc, "bad": bad}))
"""


def test_fleet_launcher_loads_no_torch(tmp_path):
    """``--fleet-size`` runs before any CUDA initialisation: the launcher
    imports no torch (and no JAX); its two ranks write the files."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("G2VEC_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _LAUNCHER_SCRIPT,
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "bad": []}
    for suffix in ("biomarkers", "lgroups", "vectors"):
        assert (tmp_path / f"tiny_{suffix}.txt").exists()


def test_batch_cli_runs_without_jax_in_sys_modules(tmp_path):
    """The batch engine, the lane trainer and stages 5-6 over the lanes
    are on this run's path (the lane products' plain versions, on the
    CPU)."""
    lines = _run_cli(tmp_path, "--seeds", "2", "--metrics-jsonl",
                     str(tmp_path / "m.jsonl"), names=("tiny.s0", "tiny.s1"),
                     last_stage=">>> [batch] 7. Save results (per lane)")
    assert ">>> [batch] 4. Train (shape-bucketed lanes)" in lines
    done = [json.loads(line) for line in open(tmp_path / "m.jsonl")][-1]
    assert done["event"] == "done" and done["buckets"][0]["lanes"] == 2


def test_scenario_cli_runs_without_jax_in_sys_modules(tmp_path):
    """The scenario engine (plan, the lanes, the reducers, the stability
    writer) is on this run's path."""
    lines = _run_cli(tmp_path, "--scenario", "permutation", "--replicates",
                     "2", "--metrics-jsonl", str(tmp_path / "m.jsonl"),
                     names=("tiny.obs", "tiny.p000", "tiny.p001"),
                     last_stage=">>> [batch] 7. Save results (per lane)")
    assert any(line.startswith("scenario ") and "walked=2" in line
               for line in lines)
    assert (tmp_path / "tiny_stability.txt").exists()
    events = [json.loads(line)["event"]
              for line in open(tmp_path / "m.jsonl")]
    assert events[0] == "scenario" and events[-1] == "stability"


_SERVE_SCRIPT = r"""
import json, runpy, sys, threading
mode, out_dir = sys.argv[1], sys.argv[2]
if mode == "help":
    sys.argv = ["g2vec_tpu_torch", "serve", "--help"]
    try:
        runpy.run_module("g2vec_tpu_torch", run_name="__main__")
    except SystemExit as e:
        rc = e.code
elif mode == "router":
    import os, time
    import g2vec_tpu_torch.serve.router
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.serve import client
    from g2vec_tpu_torch.serve.cli import serve_main
    files = write_synthetic_tsv(SyntheticSpec(
        n_good=12, n_poor=10, module_size=8, n_background=10, n_expr_only=2,
        n_net_only=2, module_chords=2, background_edges=15, seed=3), out_dir)
    fleet = out_dir + "/fleet"
    t = threading.Thread(target=serve_main, args=([
        "--replicas", "1", "--listen", "127.0.0.1:0", "--state-dir", fleet,
        "--device", "cpu"],), daemon=True)
    t.start()
    deadline = time.time() + 120
    while not os.path.exists(fleet + "/router_addr") and t.is_alive() \
            and time.time() < deadline:
        time.sleep(0.1)
    addr = open(fleet + "/router_addr").read().strip()
    events = client.submit_job(addr, dict(
        expression_file=files["expression"], clinical_file=files["clinical"],
        network_file=files["network"], result_name=out_dir + "/tiny",
        lenPath=10, numRepetition=3, sizeHiddenlayer=8, epoch=4,
        numBiomarker=5, kmeans_iters=20), timeout=120)
    st = client.status(addr)
    client.shutdown(addr, timeout=30)
    t.join(timeout=120)
    rc = 0 if (events[-1]["event"] == "job_done"
               and events[0]["replica"] == "r0"
               and st["role"] == "router" and not t.is_alive()) else 1
else:
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.serve import client
    from g2vec_tpu_torch.serve.daemon import ServeDaemon, ServeOptions
    files = write_synthetic_tsv(SyntheticSpec(
        n_good=12, n_poor=10, module_size=8, n_background=10, n_expr_only=2,
        n_net_only=2, module_chords=2, background_edges=15, seed=3), out_dir)
    d = ServeDaemon(ServeOptions(socket_path=out_dir + "/s.sock",
                                 state_dir=out_dir + "/state", device="cpu",
                                 ann_nlist=2), console=lambda s: None)
    t = threading.Thread(target=d.serve_forever, daemon=True)
    t.start()
    assert client.wait_ready(out_dir + "/s.sock", deadline_s=60)
    events = client.submit_job(out_dir + "/s.sock", dict(
        expression_file=files["expression"], clinical_file=files["clinical"],
        network_file=files["network"], result_name=out_dir + "/tiny",
        lenPath=10, numRepetition=3, sizeHiddenlayer=8, epoch=4,
        numBiomarker=5, kmeans_iters=20, seeds=2), timeout=120)
    query = client.query(out_dir + "/s.sock", "list", timeout=30)
    ok = True
    if mode == "update":
        # The incremental engine (incremental.py) on the first bundle.
        jid = events[-1]["job_id"]
        up = client.update_job(out_dir + "/s.sock", jid, dict(
            expression_file=files["expression"],
            clinical_file=files["clinical"], network_file=files["network"],
            result_name=out_dir + "/tiny_u", lenPath=10, numRepetition=3,
            sizeHiddenlayer=8, epoch=4, numBiomarker=5, kmeans_iters=20),
            idem_key="u-1", variant="s0", timeout=120)
        ok = (up[-1]["event"] == "job_done"
              and up[-1]["stats"]["mode"] == "bootstrap")
    client.shutdown(out_dir + "/s.sock", timeout=30)
    t.join(timeout=120)
    rc = 0 if (ok and events[-1]["event"] == "job_done" and not t.is_alive()
               and len(query["bundles"]) == 2) else 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes",
                                    "g2vec_tpu"))
print(json.dumps({"rc": rc, "bad": bad, "torch": "torch" in sys.modules}))
"""


@pytest.mark.parametrize("mode", ["help", "daemon", "router", "update"])
def test_serve_runs_without_jax_in_sys_modules(tmp_path, mode):
    """``python -m g2vec_tpu_torch serve --help`` loads neither jax nor
    torch; the daemon (admission, a joined batch, bundle publication, a
    query, shutdown; with ``update``, an update of a bundle) loads no jax;
    the router (``serve --replicas 1``, one routed job on its ``--device
    cpu`` replica, shutdown) loads neither."""
    proc = subprocess.run([sys.executable, "-c", _SERVE_SCRIPT, mode,
                           str(tmp_path)], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT), timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"rc": 0, "bad": [],
                      "torch": mode in ("daemon", "update")}, \
        proc.stderr[-2000:]
    if mode == "help":
        assert "--socket ADDR" in proc.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")


def test_entry_points_refuse_to_fall_back_to_cpu(no_card, tmp_path):
    import numpy as np

    from g2vec_tpu_torch.__main__ import main
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.ops.graph import edge_weights
    from g2vec_tpu_torch.train.stream import train_cbow_streaming
    from g2vec_tpu_torch.train.trainer import (LaneTrainSpec, train_cbow,
                                               train_cbow_lanes)

    files = write_synthetic_tsv(SyntheticSpec(seed=1), str(tmp_path))
    for mode in ("full", "streaming"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([files["expression"], files["clinical"], files["network"],
                  str(tmp_path / "out"), "--train-mode", mode])
    assert not list(tmp_path.glob("out_*"))
    for batch in (["--seeds", "2"], ["--seeds", "2", "--train-mode",
                                     "streaming"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([files["expression"], files["clinical"], files["network"],
                  str(tmp_path / "out"), *batch])
    assert not list(tmp_path.glob("out*"))
    lanes = [LaneTrainSpec(np.packbits(np.eye(4, 16, dtype=bool), axis=1),
                           np.array([0, 1, 0, 1]), seed) for seed in (0, 1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cbow_lanes(lanes, n_genes=16, hidden=4, learning_rate=0.01,
                         max_epochs=1)
    paths = np.packbits(np.eye(4, 16, dtype=bool), axis=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cbow(paths, np.array([0, 1, 0, 1]), n_genes=16, hidden=4,
                   learning_rate=0.01, max_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edge_weights(np.ones((3, 4), np.float32), np.array([0]),
                     np.array([1]))
    edges = (np.array([0]), np.array([1]), np.array([0.9], np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cbow_streaming(groups=[edges, edges], n_genes=16, genes=[],
                             hidden=4, learning_rate=0.01, max_epochs=1,
                             len_path=3, reps=1)


@pytest.mark.parametrize("extra", [
    ("--walker-backend", "device", "--cache-dir", "cache"),
    ("--train-mode", "streaming", "--shard-paths", "16", "--walker-backend",
     "device")], ids=["device-walker", "device-feed"])
def test_device_walker_cli_runs_without_jax_in_sys_modules(tmp_path, extra):
    """The device walker, the walk cache and the device feed are on these
    runs' paths (their plain versions, on the CPU)."""
    lines = _run_cli(tmp_path, *extra)
    assert not any("[sampler] native" in line for line in lines)


def test_device_walker_refuses_to_fall_back_to_cpu(no_card):
    import numpy as np

    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops.host_walker import plan_shards

    edges = (np.array([0]), np.array([1]), np.array([0.9], np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dw.walk_packed_rows_device(*edges, 4, len_path=3, reps=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dw.walk_shard_device(*edges, 4, plan_shards(4, 1, 4, len_path=3), 0,
                             seed=0)
