"""The port's edge partition over two real processes on the CPU.

At tests/test_edge.py's spec (``--device cpu``, f32), through the port's
CLI with the ``G2VEC_*`` environment (rank 0 hosts the store) and
``G2VEC_FORBID_FULL_NETWORK=1`` in both ranks:

- ``--edge-partition handoff`` and ``halo`` on two ranks (``--distributed
  --graph-shards 2 --embed-shards 2``) write the same bytes, with the same
  val accuracy and path count, as the same two ranks without the flag
  (which read the whole network, so without the pin), and hold the
  reference's band (|dACC| <= 0.20, top-N biomarker overlap >= 0.6)
  against the port's one-rank unpartitioned streaming run;
- a rank SIGKILLed at the ``walk_handoff`` seam (handoff) or at the
  ``halo_build`` seam (halo) is named by the survivor: it exits nonzero
  with ``PeerTimeoutError`` and ``missing rank(s): [1]``.
"""
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def edge_tsv(tmp_path_factory):
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)

    spec = SyntheticSpec(
        n_good=30, n_poor=26, module_size=16, shared_module_size=6,
        n_background=24, n_expr_only=4, n_net_only=4, module_chords=3,
        background_edges=40, noise=0.25, shift=1.4, seed=7)
    return write_synthetic_tsv(spec,
                               str(tmp_path_factory.mktemp("edge_fleet")))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _argv(paths, out, *flags):
    return [sys.executable, "-m", "g2vec_tpu_torch", paths["expression"],
            paths["clinical"], paths["network"], out, "-p", "20", "-r", "4",
            "-s", "32", "-e", "8", "-n", "10", "--seed", "11",
            "--compute-dtype", "float32", "--walker-backend", "native",
            "--train-mode", "streaming", "--shard-paths", "64",
            "--stream-patience", "8", "--device", "cpu", *flags]


def _fleet(argv, timeout=180, pin=True):
    """Both ranks of ``argv`` (under ``G2VEC_FORBID_FULL_NETWORK=1``
    when ``pin``): [(returncode, stdout, stderr)]."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("G2VEC_", "JAX_", "XLA_"))}
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        env.update(G2VEC_COORDINATOR=f"127.0.0.1:{port}",
                   G2VEC_PROCESS_ID=str(rank), G2VEC_NUM_PROCESSES="2")
        if pin:
            env["G2VEC_FORBID_FULL_NETWORK"] = "1"
        procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
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


def _files(result_name):
    out = []
    for suffix in ("_biomarkers.txt", "_lgroups.txt", "_vectors.txt"):
        with open(result_name + suffix, "rb") as f:
            out.append(f.read())
    return out


def _val_acc(stdout):
    """The last epoch line's val accuracy and the path count, from rank
    0's transcript."""
    acc = [ln for ln in stdout.splitlines() if "ACC[val]=" in ln][-1]
    paths = [ln for ln in stdout.splitlines() if "n_paths :" in ln][-1]
    return (float(acc.split("ACC[val]=")[1].split()[0]),
            int(paths.split(":")[1].split()[0]))


def test_two_ranks_handoff_equals_halo_and_holds_the_band(edge_tsv,
                                                          tmp_path):
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.pipeline import run

    plain = run(G2VecConfig(
        expression_file=edge_tsv["expression"],
        clinical_file=edge_tsv["clinical"],
        network_file=edge_tsv["network"], result_name=str(tmp_path / "plain"),
        lenPath=20, numRepetition=4, sizeHiddenlayer=32, epoch=8,
        numBiomarker=10, seed=11, compute_dtype="float32",
        walker_backend="native", train_mode="streaming", shard_paths=64,
        stream_patience=8, device="cpu"), console=lambda s: None)
    seen = {}
    for mode in ("handoff", "halo", "off"):
        out = str(tmp_path / mode)
        results = _fleet(_argv(edge_tsv, out, "--distributed",
                               "--graph-shards", "2", "--embed-shards", "2",
                               "--edge-partition", mode,
                               "--fleet-watchdog-deadline", "120"),
                         pin=mode != "off")
        for r, (rc, _, stderr) in enumerate(results):
            assert rc == 0, f"{mode} rank {r} failed:\n{stderr[-3000:]}"
        assert results[1][1] == ""               # rank 1 neither narrates
        assert not os.path.exists(out + "_r1")
        seen[mode] = _val_acc(results[0][1])
        assert (f"[edge] {mode}: rank 0/2 owns genes" in results[0][1]) \
            == (mode != "off")
    assert _files(str(tmp_path / "handoff")) == _files(str(tmp_path / "halo"))
    assert _files(str(tmp_path / "handoff")) == _files(str(tmp_path / "off"))
    assert seen["handoff"] == seen["halo"] == seen["off"]
    acc, n_paths = seen["handoff"]
    assert n_paths == plain.n_paths
    assert abs(acc - plain.acc_val) <= 0.20
    with open(str(tmp_path / "handoff") + "_biomarkers.txt") as f:
        bm = f.read().split()[1:]
    assert len(set(bm) & set(plain.biomarkers)) / len(plain.biomarkers) \
        >= 0.6


@pytest.mark.parametrize("mode,seam", [("handoff", "walk_handoff"),
                                       ("halo", "halo_build")])
def test_sigkilled_rank_at_an_edge_seam_is_named(edge_tsv, tmp_path, mode,
                                                 seam):
    results = _fleet(_argv(
        edge_tsv, str(tmp_path / "out"), "--distributed", "--graph-shards",
        "2", "--embed-shards", "2", "--edge-partition", mode,
        "--fleet-watchdog-deadline", "4", "--fault-plan",
        f"process=1,stage={seam},kind=sigkill"))
    assert results[1][0] == -9                  # rank 1 really SIGKILLed
    rc0, _, stderr0 = results[0]
    assert rc0 == 1
    assert "PeerTimeoutError" in stderr0
    assert "missing rank(s): [1]" in stderr0
    assert not (tmp_path / "out_vectors.txt").exists()
