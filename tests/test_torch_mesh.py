"""The port's ``--mesh`` runs against the JAX package's mesh functions.

- The mesh context: ``make_mesh_context`` over the CPU device, the
  reference's refusal of a mesh larger than the visible devices (its
  message without the XLA hint), and the specs as plain data.
- ``plan_hybrid_mesh`` on mock slice-tagged devices equals the
  reference's (``tests/test_multislice_mesh.py``'s cases), its
  divisibility error included.
- Two port ranks over a real store (two processes, the ``G2VEC_*``
  environment): ``sharded_native_path_set`` returns, on each, the JAX
  package's single-process ``generate_path_set_native`` set byte for
  byte, on an uneven split of the walker axis; a single-layout restore is
  rank 0's read broadcast (the same leaves on both ranks, the same
  refusal when every generation is corrupt); a sharded save is rank 0's
  write behind a store barrier, read back by both; the global plan is
  held to two devices.
- The trainer under a 1x1 mesh turns fused eval off (two forward calls an
  epoch) and writes the fused run's bytes at bf16; a mesh over two
  devices in one process is refused.
- The CLI, ``--distributed --mesh 2x1 --device cpu`` on two ranks given
  the JAX composition's draws (tests/test_torch_pipeline.py's spec at
  f32): the single-process run's three files byte for byte, and the
  reference's ``_lgroups``/``_biomarkers`` bytes.
"""
import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from g2vec_tpu.ops import host_walker as jwalker
from g2vec_tpu.parallel import distributed as jdist
from g2vec_tpu_torch.parallel import distributed, mesh
from g2vec_tpu_torch.train import checkpoint as ck
from g2vec_tpu_torch.train import trainer as ttrainer

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(port, rank, n_ranks, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("G2VEC_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(G2VEC_COORDINATOR=f"127.0.0.1:{port}",
               G2VEC_PROCESS_ID=str(rank), G2VEC_NUM_PROCESSES=str(n_ranks),
               **extra)
    return env


def _ranks(argv_of, n=2, timeout=240, **extra):
    """One process a rank; [(returncode, stdout, stderr)] in rank order."""
    port = _free_port()
    procs = [subprocess.Popen(argv_of(r), env=_env(port, r, n, **extra),
                              cwd=ROOT, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(n)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


# ---------------------------------------------------------------------------
# The mesh context and the planning
# ---------------------------------------------------------------------------

def test_mesh_context_on_the_cpu_and_its_refusal():
    ctx = mesh.make_mesh_context((1, 1), devices=mesh.visible_devices("cpu"))
    assert ctx.shape == (1, 1) and ctx.n_devices == 1
    assert ctx.mesh.tolist() == [[torch.device("cpu")]]
    assert mesh.make_mesh_context(None).mesh is None
    assert mesh.make_mesh_context(None).n_devices == 1
    with pytest.raises(ValueError) as e:
        mesh.make_mesh_context((2, 1), devices=mesh.visible_devices("cpu"))
    assert str(e.value) == "mesh (2, 1) needs 2 devices, only 1 visible"
    # The reference's canonical specs, as axis names per dimension.
    assert ctx.batch_spec == (mesh.DATA_AXIS, mesh.MODEL_AXIS)
    assert ctx.w_ih_spec == (mesh.MODEL_AXIS, None)
    assert ctx.packed_batch_spec == (mesh.DATA_AXIS, None)
    assert mesh.pad_to_multiple(10, 4) == 12
    assert mesh.pad_to_multiple(8, 4) == 8


def _fake_pod(n_slices, per_slice):
    return [SimpleNamespace(slice_index=s, id=s * per_slice + i)
            for s in range(n_slices) for i in range(per_slice)]


@pytest.mark.parametrize("devices,data,model", [
    (_fake_pod(2, 4), 4, 2), (_fake_pod(4, 2), 8, 1), (_fake_pod(1, 8), 4, 2),
    ([SimpleNamespace(id=i) for i in range(8)], 8, 1),
    (_fake_pod(2, 4), 3, 2), (_fake_pod(3, 2), 4, 1)],
    ids=["two-slice", "four-slice", "one-slice", "no-metadata",
         "indivisible", "indivisible-3"])
def test_plan_hybrid_mesh_is_the_reference(devices, data, model):
    def plan(mod):
        try:
            return mod.plan_hybrid_mesh(devices, data, model)
        except ValueError as e:
            return f"ValueError: {e}"

    assert plan(distributed) == plan(jdist)


def test_fetch_global_is_a_host_copy_of_a_replicated_value():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    got = distributed.fetch_global(t)
    assert isinstance(got, np.ndarray) and np.array_equal(got, t.numpy())
    bf = distributed.fetch_global(t.to(torch.bfloat16))
    assert bf.dtype == np.float32 and np.array_equal(bf, t.numpy())
    arr = np.ones(3)
    assert distributed.fetch_global(arr) is arr


# ---------------------------------------------------------------------------
# Two ranks over the store
# ---------------------------------------------------------------------------

_RANK_WORKER = r"""
import json, sys
import numpy as np
import torch
from g2vec_tpu_torch.parallel import distributed
from g2vec_tpu_torch.train import checkpoint as ck

args, out_dir, good, bad, fresh = sys.argv[1:6]
distributed.initialize()
rank = distributed.process_index()
a = np.load(args)
rows = distributed.sharded_native_path_set(
    a["src"], a["dst"], a["w"], int(a["g"]), len_path=int(a["len_path"]),
    reps=int(a["reps"]), seed=int(a["seed"]), n_threads=2)
with open(f"{out_dir}/rows{rank}.bin", "wb") as f:
    f.write(b"".join(sorted(rows)))
like = [torch.zeros(12, 4), torch.zeros(4, 1)]
opt = (0, like, like)
report = {"rank": rank, "fleet": distributed.shared_card_fleet(),
          "global": distributed.make_global_mesh((2, 1), "cpu").n_devices}
try:
    distributed.make_global_mesh((4, 1), "cpu")
except ValueError as e:
    report["too_large"] = str(e)
got = ck.load_state(good, like, opt)
report["single"] = [got[3], float(got[0][0].sum()), float(got[2][1].sum())]
try:
    ck.load_state(bad, like, opt)
except ValueError as e:
    report["refusal"] = str(e)
report["none"] = ck.load_state(fresh + "/none", like, opt) is None
p = [torch.full((12, 4), 0.5), torch.full((4, 1), -1.0)]
ck.save_state(fresh + "/sharded", p, (3, p, p), p, 7, 0.6, 0.7,
              layout="sharded")
got = ck.load_state(fresh + "/sharded", like, opt, layout="sharded")
report["sharded"] = [got[3], got[4], float(got[0][1].sum())]
print(json.dumps(report))
distributed.shutdown()
"""


def test_two_ranks_walk_restore_and_save_over_the_store(tmp_path):
    rng = np.random.default_rng(3)
    g, reps = 61, 3           # 183 walkers: an uneven split over two ranks
    src = rng.integers(0, g, 400).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, g - 1, 400)) % g).astype(np.int32)
    w = (rng.random(400) + 0.1).astype(np.float32)
    np.savez(tmp_path / "args.npz", src=src, dst=dst, w=w, g=g, len_path=9,
             reps=reps, seed=7)
    # A good single checkpoint, and one whose every generation is corrupt.
    from g2vec_tpu_torch.resilience.faults import _corrupt_file

    gen = torch.Generator().manual_seed(0)
    p = [torch.randn(12, 4, generator=gen), torch.randn(4, 1, generator=gen)]
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    ck.save_state(good, p, (5, p, p), p, 9, 0.5, 0.6)
    for _ in range(2):
        ck.save_state(bad, p, (5, p, p), p, 9, 0.5, 0.6)
    _corrupt_file(os.path.join(bad, ck.CKPT_NAME))
    _corrupt_file(os.path.join(bad, ck.CKPT_NAME + ck.PREV_SUFFIX))
    worker = tmp_path / "worker.py"
    worker.write_text(_RANK_WORKER)
    results = _ranks(lambda r: [sys.executable, str(worker),
                                str(tmp_path / "args.npz"), str(tmp_path),
                                good, bad, str(tmp_path / "fresh")])
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{err[-3000:]}"
    want = jwalker.generate_path_set_native(src, dst, w, g, len_path=9,
                                            reps=reps, seed=7)
    want_bytes = b"".join(sorted(want))
    for r in range(2):
        assert (tmp_path / f"rows{r}.bin").read_bytes() == want_bytes
    reports = [json.loads(out.splitlines()[-1]) for _, out, _ in results]
    assert [rep["rank"] for rep in reports] == [0, 1]
    for rep in reports:
        assert rep["fleet"] is True and rep["global"] == 2
        assert rep["too_large"] == ("mesh (4, 1) needs 4 devices; the global "
                                    "runtime has 2 (processes: 2)")
        assert rep["single"] == [9, float(p[0].sum()), float(p[1].sum())]
        assert "restore failed on the coordinator" in rep["refusal"]
        assert "no intact checkpoint" in rep["refusal"]
        assert rep["none"] is True
        assert rep["sharded"] == [7, 0.6, -4.0]
    # Rank 0 alone wrote the sharded generation.
    names = sorted(os.listdir(tmp_path / "fresh" / "sharded"))
    assert names == [ck.SHARDED_NAME + ".0",
                     ck.SHARDED_NAME + ".0" + ck.MANIFEST_SUFFIX,
                     ck.SHARDED_NAME + ".LATEST"]


# ---------------------------------------------------------------------------
# The trainer under a mesh
# ---------------------------------------------------------------------------

def test_trainer_under_a_mesh_runs_without_fused_eval(monkeypatch):
    from g2vec_tpu_torch.ops import packed_matmul as pm

    rng = np.random.default_rng(0)
    dense = rng.random((200, 90)) < 0.06
    labels = (dense[:, :30].sum(1) > dense[:, 30:60].sum(1)).astype(np.int32)
    packed = np.packbits(dense, axis=1)
    calls = []
    real = pm.packed_matmul_fwd

    def counted(p, w):
        calls.append(p.shape[0])
        return real(p, w)

    monkeypatch.setattr(pm, "packed_matmul_fwd", counted)
    common = dict(n_genes=90, hidden=8, learning_rate=0.01, max_epochs=6,
                  seed=1, device="cpu")
    fused = ttrainer.train_cbow(packed, labels, **common)
    n_fused = list(calls)
    calls.clear()
    ctx = mesh.make_mesh_context((1, 1), devices=[torch.device("cpu")])
    split = ttrainer.train_cbow(packed, labels, mesh_ctx=ctx, **common)
    iterations = len(n_fused)
    assert all(m == 200 for m in n_fused)
    assert len(calls) == 2 * iterations
    assert sorted(set(calls)) == [40, 160]        # val rows, train rows
    assert split.w_ih.tobytes() == fused.w_ih.tobytes()
    assert [h["acc_val"] for h in split.history] == \
        [h["acc_val"] for h in fused.history]
    two = mesh.make_mesh_context((2, 1), devices=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="one device"):
        ttrainer.train_cbow(packed, labels, mesh_ctx=two, **common)


# ---------------------------------------------------------------------------
# The CLI on two ranks against the single-process run and the reference
# ---------------------------------------------------------------------------

# The CLI's own entry with the test's draws injected into pipeline.run.
_CLI_WORKER = r"""
import os, runpy, sys
import numpy as np
import g2vec_tpu_torch.pipeline as pipeline
draws = np.load(os.environ["G2V_TEST_DRAWS"])
_run = pipeline.run


def run(cfg, *args, **kwargs):
    kwargs.setdefault("init", (draws["w_ih"], draws["w_ho"]))
    kwargs.setdefault("kmeans_centers0", draws["centers0"])
    return _run(cfg, *args, **kwargs)


pipeline.run = run
sys.argv = ["g2vec_tpu_torch", *sys.argv[1:]]
runpy.run_module("g2vec_tpu_torch", run_name="__main__")
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.data.synthetic import write_synthetic_tsv
    from g2vec_tpu_torch.pipeline import run

    from test_torch_pipeline import ARGS, SPEC, _jax_composition

    tmp = tmp_path_factory.mktemp("mesh")
    files = write_synthetic_tsv(SPEC, str(tmp))
    from g2vec_tpu import preprocess as jprep
    from g2vec_tpu.io import readers as jreaders

    n_common = len(jprep.find_common_genes(
        jreaders.load_network(files["network"]).genes,
        jreaders.load_expression(files["expression"]).gene))
    rng = np.random.default_rng(5)
    hidden = ARGS["sizeHiddenlayer"]
    init = ((np.clip(rng.standard_normal((n_common, hidden)), -2, 2)
             / np.sqrt(hidden)).astype(np.float32),
            (np.clip(rng.standard_normal((hidden, 1)), -2, 2)
             / np.sqrt(hidden)).astype(np.float32))
    centers0 = init[0][rng.choice(n_common, size=(10, 3), replace=True)]
    draws = str(tmp / "draws.npz")
    np.savez(draws, w_ih=init[0], w_ho=init[1], centers0=centers0)
    _, jax_files, _ = _jax_composition(files, str(tmp / "jax"), init,
                                       centers0)
    solo = run(G2VecConfig(
        expression_file=files["expression"], clinical_file=files["clinical"],
        network_file=files["network"], result_name=str(tmp / "solo"),
        compute_dtype="float32", device="cpu", **ARGS),
        console=lambda s: None, init=init, kmeans_centers0=centers0)
    worker = tmp / "cli.py"
    worker.write_text(_CLI_WORKER)
    flags = ["-p", str(ARGS["lenPath"]), "-r", str(ARGS["numRepetition"]),
             "-s", str(hidden), "-e", str(ARGS["epoch"]), "-n",
             str(ARGS["numBiomarker"]), "--seed", str(ARGS["seed"]),
             "--compute-dtype", "float32", "--device", "cpu",
             "--sampler-threads", "2", "--distributed", "--mesh", "2x1"]
    results = _ranks(lambda r: [
        sys.executable, str(worker), files["expression"], files["clinical"],
        files["network"], str(tmp / "mesh"), *flags], G2V_TEST_DRAWS=draws)
    return dict(tmp=tmp, jax_files=jax_files, solo=solo, results=results)


def test_mesh_cli_on_two_ranks_writes_the_single_process_bytes(mesh_runs):
    results = mesh_runs["results"]
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{err[-3000:]}"
    out0, out1 = results[0][1], results[1][1]
    assert "[fleet] shared card: replicated local mesh 1x1 per rank " \
           "(global plan (2, 1))" in out0
    assert out1 == ""                      # rank 1 neither narrates nor writes
    for suffix, path in zip(("biomarkers", "lgroups", "vectors"),
                            mesh_runs["solo"].output_files):
        mine = f"{mesh_runs['tmp'] / 'mesh'}_{suffix}.txt"
        with open(mine, "rb") as a, open(path, "rb") as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize("suffix", ["biomarkers", "lgroups"])
def test_mesh_cli_selection_files_are_the_references(mesh_runs, suffix):
    mine = f"{mesh_runs['tmp'] / 'mesh'}_{suffix}.txt"
    ref = mesh_runs["jax_files"][("biomarkers", "lgroups").index(suffix)]
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_collectives_frame_payloads_past_the_stores_value_limit(
        monkeypatch):
    """The store refuses a value over 8 MiB: an allgather or a broadcast
    of 20 MB goes in chunks and comes back whole, a small one inline."""
    import datetime
    import threading

    from torch.distributed import TCPStore

    from g2vec_tpu_torch.parallel import hostcomm

    store = TCPStore("127.0.0.1", 0, 2, True,
                     timeout=datetime.timedelta(seconds=30),
                     wait_for_workers=False)
    monkeypatch.setattr(distributed, "_world", distributed._World(
        0, 2, "127.0.0.1", store.port, store))
    big = np.random.default_rng(0).bytes(20 * 2 ** 20)
    peer = TCPStore("127.0.0.1", store.port, 2, False,
                    timeout=datetime.timedelta(seconds=30))
    seq = next(hostcomm._seq) + 1      # the next two collectives' numbers
    got = {}

    def rank_1():
        # Rank 1's side of both collectives, through the same framing.
        hostcomm._publish(peer, f"g2vec/ag/{seq}/big/1", big[::-1])
        got["bc"] = hostcomm._fetch(peer, f"g2vec/bc/{seq + 1}/bc",
                                    time.monotonic() + 30)

    t = threading.Thread(target=rank_1)
    t.start()
    out = hostcomm.allgather_bytes("big", big, deadline=30)
    assert hostcomm.broadcast_bytes("bc", b"small", deadline=30) == b"small"
    t.join(timeout=30)
    assert out == [big, big[::-1]] and got["bc"] == b"small"
    assert store.get(f"g2vec/ag/{seq}/big/0") == hostcomm._CHUNKED
    assert store.get(f"g2vec/bc/{seq + 1}/bc") == b"\x00small"
