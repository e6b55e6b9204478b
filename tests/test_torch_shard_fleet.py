"""The port's sharded streaming run over real processes on the CPU.

At tests/test_shard.py's spec (``--device cpu``, f32):

- a 2-process port fleet (``--distributed --graph-shards 2
  --embed-shards 2``, the ``G2VEC_*`` environment, rank 0 hosting the
  store) finishes on both ranks with identical selections, and rank 0
  alone writes; it holds the reference's band (|dACC| <= 0.20, top-N
  biomarker overlap >= 0.6) against the port's unsharded run and against
  the JAX package's own 2-process fleet (``tests/shard_worker.py``), the
  port's runs given the JAX fleet's draws (its init, and its k-means++
  centres, which the reference's functions recompute from its vectors
  file): at this size the L-groups move with the k-means draw;
- a rank SIGKILLed at the ``shard_exchange`` seam, or at the
  ``embed_allreduce`` seam mid-training, is named by the survivor: it
  exits nonzero with ``PeerTimeoutError`` and ``missing rank(s): [1]`` in
  its stderr, through the port's CLI, within a short deadline.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One rank of the port's fleet, in process: prints its selections.
_WORKER = r"""
import json, os, sys
import numpy as np
from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.parallel import distributed
from g2vec_tpu_torch.pipeline import run
cfg = G2VecConfig(**json.loads(sys.argv[1]))
draws = np.load(sys.argv[2])
try:
    distributed.initialize()
    rank = distributed.process_index()
    res = run(cfg, console=lambda s: None,
              init=(draws["w_ih"], draws["w_ho"]),
              kmeans_centers0=draws["centers0"])
except BaseException:
    import traceback
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)
distributed.shutdown()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                           "g2vec_tpu"))
print(json.dumps({"process": rank,
                  "acc_val": float(res.acc_val),
                  "biomarkers": list(res.biomarkers),
                  "lgroups": res.lgroup_idx.tolist(),
                  "n_paths": int(res.n_paths),
                  "output_files": list(res.output_files),
                  "rows": int(res.embeddings.shape[0]), "bad": bad}))
"""


@pytest.fixture(scope="module")
def shard_tsv(tmp_path_factory):
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)

    spec = SyntheticSpec(
        n_good=30, n_poor=26, module_size=16, shared_module_size=6,
        n_background=24, n_expr_only=4, n_net_only=4, module_chords=3,
        background_edges=40, noise=0.25, shift=1.4, seed=7)
    return write_synthetic_tsv(spec,
                               str(tmp_path_factory.mktemp("fleet_data")))


def _cfg(paths, out, **over):
    base = dict(
        expression_file=paths["expression"], clinical_file=paths["clinical"],
        network_file=paths["network"], result_name=out,
        lenPath=20, numRepetition=4, sizeHiddenlayer=32, epoch=8,
        numBiomarker=10, seed=11, compute_dtype="float32",
        walker_backend="native", train_mode="streaming", shard_paths=64)
    base.update(over)
    return base


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(port: int, rank: int, n_ranks: int, jax: bool = False) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("G2VEC_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    env.update(G2VEC_COORDINATOR=f"127.0.0.1:{port}",
               G2VEC_PROCESS_ID=str(rank), G2VEC_NUM_PROCESSES=str(n_ranks))
    return env


def _fleet(commands, timeout=300):
    """Start one process a rank (``commands[rank] = (argv, env)``) and
    wait for all: [(returncode, stdout, stderr)]."""
    procs = [subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for argv, env in commands]
    out = []
    try:
        for i, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {i} timed out after {timeout}s")
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:                     # a dead sibling must not wedge
            if p.poll() is None:
                p.kill()
    return out


def _last_json(stdout):
    return json.loads([ln for ln in stdout.splitlines() if ln][-1])


def _band(a_acc, a_bm, b_acc, b_bm):
    overlap = len(set(a_bm) & set(b_bm)) / max(len(set(a_bm)), 1)
    return abs(a_acc - b_acc), overlap


def _reference_fleet(shard_tsv, tmp_path):
    """The JAX package's 2-process fleet on the spec: rank 0's report."""
    jcfg = _cfg(shard_tsv, str(tmp_path / "jfleet"), stream_patience=8,
                distributed=True, graph_shards=2, embed_shards=2,
                fleet_watchdog_deadline=120.0)
    jpath = tmp_path / "jcfg.json"
    jpath.write_text(json.dumps(jcfg))
    port = _free_port()
    results = _fleet([([sys.executable,
                        os.path.join(ROOT, "tests", "shard_worker.py"),
                        str(jpath)], _env(port, r, 2, jax=True))
                      for r in range(2)], timeout=420)
    for r, (rc, _, stderr) in enumerate(results):
        assert rc == 0, f"JAX rank {r} failed:\n{stderr[-3000:]}"
    return _last_json(results[0][1])


def _reference_draws(tmp_path, n_genes):
    """The JAX fleet's draws, for the port's runs: its init (a slice of the
    unsharded one for the train seed, 11) and its k-means++ centres
    (kmeans_sharded's seeding for k-means seed 0, on a sample that at this
    size is the whole table, here read back from its vectors file)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from g2vec_tpu.models.cbow import init_params
    from g2vec_tpu.ops.kmeans import _kmeanspp_init

    draw = init_params(jax.random.key(11), n_genes, 32)
    emb = np.loadtxt(tmp_path / "jfleet_vectors.txt", skiprows=1,
                     usecols=range(1, 33), dtype=np.float32)
    keys = jax.random.split(jax.random.key(0), 10)
    centers0 = np.stack([np.asarray(_kmeanspp_init(jnp.asarray(emb), 3, k))
                         for k in keys])
    path = tmp_path / "draws.npz"
    np.savez(path, w_ih=np.asarray(draw.w_ih), w_ho=np.asarray(draw.w_ho),
             centers0=centers0)
    return path


def test_two_rank_port_fleet_holds_the_band(shard_tsv, tmp_path):
    import numpy as np

    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.pipeline import run

    jax0 = _reference_fleet(shard_tsv, tmp_path)
    draws = _reference_draws(tmp_path, jax0["n_genes"])
    d = np.load(draws)
    plain = run(G2VecConfig(**_cfg(shard_tsv, str(tmp_path / "plain"),
                                   stream_patience=8, device="cpu")),
                console=lambda s: None, init=(d["w_ih"], d["w_ho"]),
                kmeans_centers0=d["centers0"])
    port = _free_port()
    cfg = _cfg(shard_tsv, str(tmp_path / "fleet"), stream_patience=8,
               device="cpu", distributed=True, graph_shards=2,
               embed_shards=2, fleet_watchdog_deadline=120.0)
    results = _fleet([([sys.executable, "-c", _WORKER, json.dumps(cfg),
                        str(draws)], _env(port, r, 2)) for r in range(2)])
    ranks = []
    for r, (rc, stdout, stderr) in enumerate(results):
        assert rc == 0, f"rank {r} failed:\n{stderr[-3000:]}"
        ranks.append(_last_json(stdout))
    assert [p["process"] for p in ranks] == [0, 1]
    assert all(p["bad"] == [] for p in ranks)
    # Replicated decisions; each rank holds its own gene rows.
    for key in ("biomarkers", "lgroups", "acc_val", "n_paths"):
        assert ranks[0][key] == ranks[1][key], key
    assert ranks[0]["rows"] + ranks[1]["rows"] == plain.n_genes
    # Rank 0 alone writes.
    assert ranks[1]["output_files"] == []
    assert [os.path.basename(p) for p in ranks[0]["output_files"]] == \
        ["fleet_biomarkers.txt", "fleet_lgroups.txt", "fleet_vectors.txt"]
    with open(tmp_path / "fleet_vectors.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == plain.n_genes + 1
    assert [ln.split("\t", 1)[0] for ln in lines[1:]] == list(plain.genes)
    for acc, bm in ((plain.acc_val, plain.biomarkers),
                    (jax0["acc_val"], jax0["biomarkers"])):
        acc_gap, overlap = _band(ranks[0]["acc_val"], ranks[0]["biomarkers"],
                                 acc, bm)
        assert acc_gap <= 0.20 and overlap >= 0.6, (acc_gap, overlap)
    assert ranks[0]["n_paths"] == jax0["n_paths"] == plain.n_paths


@pytest.mark.parametrize("plan", [
    "process=1,stage=shard_exchange,kind=sigkill",
    "process=1,stage=embed_allreduce,kind=sigkill,epoch=3"])
def test_sigkilled_rank_is_named_by_the_survivor(shard_tsv, tmp_path, plan):
    port = _free_port()
    argv = [sys.executable, "-m", "g2vec_tpu_torch", shard_tsv["expression"],
            shard_tsv["clinical"], shard_tsv["network"],
            str(tmp_path / "out"), "-p", "20", "-r", "4", "-s", "32", "-e",
            "8", "-n", "10", "--seed", "11", "--compute-dtype", "float32",
            "--walker-backend", "native", "--train-mode", "streaming",
            "--shard-paths", "64", "--device", "cpu", "--distributed",
            "--graph-shards", "2", "--embed-shards", "2",
            "--fleet-watchdog-deadline", "4", "--fault-plan", plan]
    results = _fleet([(argv, _env(port, r, 2)) for r in range(2)],
                     timeout=180)
    assert results[1][0] == -9                  # rank 1 really SIGKILLed
    rc0, _, stderr0 = results[0]
    assert rc0 == 1
    assert "PeerTimeoutError" in stderr0
    assert "missing rank(s): [1]" in stderr0
    assert not (tmp_path / "out_vectors.txt").exists()
