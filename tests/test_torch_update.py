"""The port's incremental updates (``g2vec_tpu_torch/incremental.py`` and
the daemon's ``update`` op) against the JAX package's, on the CPU.

- The delta model's pieces equal the JAX package's on the same inputs:
  ``resolve_ranges``, ``range_fingerprint``, the range walk keys,
  ``frontier_ranges``, ``compute_fingerprints`` of the example inputs,
  and each owner range's walks (the union is the whole-graph walk).
- The warm-start fine-tune at f32 from the same ``(w_ih, w_ho)``: the
  port's ``train_cbow`` (no row bucket) against the JAX package's
  ``train_cbow(warm_start=..., row_bucket=512)``, ``W_ih`` at rtol 1e-5;
  and a bootstrap update from the JAX package's draw equals the JAX
  ``run_update`` (stats and the fingerprints' non-graph fields exactly,
  the embedding at rtol 1e-5).
- ``delta_fingerprints.json`` is read across the packages both ways:
  either package updates a bundle the other bootstrapped as a delta
  against its file (torch's and XLA's |PCC| agree at 1e-6, not bitwise,
  so the graph hashes are each package's own), and a file holding the
  reader's own hashes, published by the other's writer, is a no-op.
- The engine on tests/test_update.py's spec (48/40 patients, ``lenPath``
  12, ``numRepetition`` 6, hidden 16, f32, the native walker): bootstrap,
  a no-op (``walked_rows == 0``, array files byte-identical), an
  expression-only change (``ranges_rewalked == 0``) and an edge delta
  held to the band against a cold retrain.
- The daemon's ``update`` op: bootstrap, no-op and dedup; the admission
  contract's rejections equal to the JAX daemon's; a SIGKILL at the
  ``update_publish`` seam leaves the prior generation serving and the
  journaled update completes on restart; the router relays an update to
  the bundle's home replica; with no card, ``run_update`` raises.
"""
import dataclasses
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from g2vec_tpu import incremental as jinc
from g2vec_tpu.config import G2VecConfig as JaxConfig
from g2vec_tpu.io import writers as jwriters
from g2vec_tpu.models.cbow import init_params as jax_init_params
from g2vec_tpu.ops import host_walker as jwalker
from g2vec_tpu.serve import daemon as jdaemon
from g2vec_tpu.train.trainer import train_cbow as jax_train
from g2vec_tpu_torch import incremental as inc
from g2vec_tpu_torch.cache import resolve_cache_tiers
from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.io.writers import read_generation, write_inventory_bundle
from g2vec_tpu_torch.models.cbow import CBOW
from g2vec_tpu_torch.ops.graph import thresholded_edges
from g2vec_tpu_torch.ops.host_walker import (ShardPlan, edges_to_csr,
                                             generate_path_set_native,
                                             walk_shard)
from g2vec_tpu_torch.pipeline import run
from g2vec_tpu_torch.resilience import faults
from g2vec_tpu_torch.serve import client, daemon, protocol, router
from g2vec_tpu_torch.train.trainer import train_cbow

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = SyntheticSpec(n_good=48, n_poor=40, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
ARRAYS = ("embeddings.npy", "norms.npy", "scores.npy", "genes.txt")


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    faults._reset_for_tests()
    yield
    faults._reset_for_tests()


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("syn")))


def _array_bytes(gen_dir):
    out = {}
    for fn in ARRAYS:
        with open(os.path.join(gen_dir, fn), "rb") as f:
            out[fn] = f.read()
    return out


# ---------------------------------------------------------------------------
# The delta model against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 5, 31, 32, 33, 57, 1000, 5850])
def test_resolve_ranges_equal_the_jax_ranges(n):
    assert inc.resolve_ranges(n) == jinc.resolve_ranges(n)
    assert inc.resolve_ranges(n, cap=7) == jinc.resolve_ranges(n, cap=7)
    assert (inc.RANGE_CAP, inc.RANGE_FAMILY, inc.DELTA_FORMAT,
            inc.BAND_DACC, inc.BAND_OVERLAP) == \
        (jinc.RANGE_CAP, jinc.RANGE_FAMILY, jinc.DELTA_FORMAT,
         jinc.BAND_DACC, jinc.BAND_OVERLAP)


def _graph(seed, n_genes=40, n_edges=90):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_genes, size=n_edges).astype(np.int32)
    d = rng.integers(0, n_genes, size=n_edges).astype(np.int32)
    w = rng.uniform(0.5, 1.0, size=n_edges).astype(np.float32)
    return s, d, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprints_keys_and_frontiers_equal_the_jax_ones(seed):
    s, d, w = _graph(seed)
    cfg = G2VecConfig(lenPath=7, numRepetition=3, seed=seed,
                      pcc_threshold=0.4)
    jcfg = JaxConfig(lenPath=7, numRepetition=3, seed=seed,
                     pcc_threshold=0.4)
    tag = inc._params_tag(cfg)
    assert tag == jinc._params_tag(jcfg)
    ranges = inc.resolve_ranges(40, cap=9)
    for lo, hi in ranges:
        fp = inc.range_fingerprint(s, d, w, lo, hi, tag)
        assert fp == jinc.range_fingerprint(s, d, w, lo, hi, tag)
        assert inc._range_walk_key(fp, lo, hi, 40, tag) == \
            jinc._range_walk_key(fp, lo, hi, 40, tag)
    rng = np.random.default_rng(seed + 10)
    for _ in range(5):
        changed = {int(c) for c in rng.choice(len(ranges), size=2)}
        assert inc.frontier_ranges(changed, ranges, s, d) == \
            jinc.frontier_ranges(changed, ranges, s, d)
    assert inc.frontier_ranges(set(), ranges, s, d) == set()


def test_compute_fingerprints_and_range_walks_equal_the_jax_ones(tsv):
    cfg = G2VecConfig(expression_file=tsv["expression"],
                      clinical_file=tsv["clinical"],
                      network_file=tsv["network"], lenPath=12,
                      numRepetition=6, device="cpu")
    jcfg = JaxConfig(expression_file=tsv["expression"],
                     clinical_file=tsv["clinical"],
                     network_file=tsv["network"], lenPath=12,
                     numRepetition=6)
    data, src, dst = inc._load_inputs(cfg)
    jdata, jsrc, jdst = jinc._load_inputs(jcfg)
    assert list(data.gene) == list(jdata.gene)
    from g2vec_tpu.cache import walk_cache_key as jkey
    from g2vec_tpu.ops.graph import thresholded_edges as jthresh
    from g2vec_tpu_torch.cache import NATIVE_FAMILY, walk_cache_key

    n = len(data.gene)
    csrs, keys, jkeys = [], [], []
    for i in range(2):
        e = thresholded_edges(data.expr[data.label == i], src, dst,
                              threshold=0.5, device="cpu")
        je = tuple(np.asarray(a) for a in jthresh(
            jdata.expr[jdata.label == i], jsrc, jdst, threshold=0.5))
        # The same edges; torch's and XLA's |PCC| agree at 1e-6, not
        # bitwise (tests/test_torch_graph_paths.py), so the hashes below
        # take one package's weights on both sides.
        np.testing.assert_array_equal(e[0], je[0])
        np.testing.assert_array_equal(e[1], je[1])
        np.testing.assert_allclose(e[2], je[2], rtol=0, atol=1e-6)
        csrs.append(e)
        kw = dict(len_path=12, reps=6, seed=i, family=NATIVE_FAMILY)
        keys.append(walk_cache_key(*e, n, **kw))
        jkeys.append(jkey(*e, n, **kw))
    assert keys == jkeys
    got = inc.compute_fingerprints(cfg, list(data.gene), data.expr,
                                   data.label, csrs, keys)
    want = jinc.compute_fingerprints(jcfg, list(jdata.gene), jdata.expr,
                                     jdata.label, csrs, keys)
    assert got == want
    # Each range's walks are the JAX package's rows for those walkers,
    # and their union is the whole-graph set.
    s, d, w = csrs[1]
    csr = edges_to_csr(s, d, w, n)
    ranges = inc.resolve_ranges(n)
    plan = ShardPlan(n_starts=n, reps=6, len_path=12,
                     starts_per_shard=ranges[0][1] - ranges[0][0])
    assert plan.n_shards == len(ranges)
    union = set()
    for ri, (lo, hi) in enumerate(ranges):
        assert plan.start_range(ri) == (lo, hi)
        rows = walk_shard(s, d, w, n, plan, ri, seed=1, n_threads=2,
                          csr=csr)
        want_rows = np.vstack([jwalker.walk_packed_rows(
            s, d, w, n, len_path=12, reps=6, seed=1, n_threads=2,
            walker_lo=rep * n + lo, walker_hi=rep * n + hi)
            for rep in range(6)])
        np.testing.assert_array_equal(rows, want_rows)
        union |= {r.tobytes() for r in rows}
    assert union == generate_path_set_native(s, d, w, n, len_path=12,
                                             reps=6, seed=1)


# ---------------------------------------------------------------------------
# The engine: bootstrap, no-op, expression only, edge delta
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prior(tsv, tmp_path_factory):
    """Cold run, its bundle, a bootstrap update and the generation it
    published with fingerprints: the start of every engine case."""
    tmp = tmp_path_factory.mktemp("upd_engine")
    os.makedirs(os.path.join(str(tmp), "out"))
    cfg = G2VecConfig(
        expression_file=tsv["expression"], clinical_file=tsv["clinical"],
        network_file=tsv["network"],
        result_name=os.path.join(str(tmp), "out", "cold"),
        lenPath=12, numRepetition=6, sizeHiddenlayer=16, epoch=40,
        learningRate=0.05, numBiomarker=10, compute_dtype="float32",
        walker_backend="native", device="cpu",
        cache_dir=os.path.join(str(tmp), "cache"))
    cold = run(cfg, console=lambda s: None)
    bundle = os.path.join(str(tmp), "bundle")
    write_inventory_bundle(bundle, cold.embeddings, list(cold.genes),
                           cold.biomarker_scores, {"source": "cold"},
                           ann_nlist=4, seed_centroids=cold.km_centers)
    cold_copy = os.path.join(str(tmp), "cold_bundle")
    shutil.copytree(bundle, cold_copy)
    wc = resolve_cache_tiers(cfg.cache_dir)
    up1 = inc.run_update(cfg, bundle, walk_cache=wc)
    gen2 = write_inventory_bundle(
        bundle, up1.embeddings, up1.genes, up1.biomarker_scores,
        {"source": "update"}, ann_nlist=4, seed_centroids=up1.km_centers,
        extra_files={"delta_fingerprints.json": up1.fingerprints})
    return {"cfg": cfg, "bundle": bundle, "wc": wc, "cold": cold,
            "up1": up1, "gen2": gen2, "tmp": str(tmp),
            "cold_bundle": cold_copy}


def test_bootstrap_update_rewalks_everything_once(prior):
    up1, gen2 = prior["up1"], prior["gen2"]
    st = up1.stats
    assert st["mode"] == "bootstrap"
    assert st["ranges_rewalked"] == st["ranges_total"] > 0
    assert st["walked_rows"] > 0
    assert st["carried_rows"] == st["n_genes"]
    assert st["epochs"] == 10                    # max(3, 40 // 4)
    fp = up1.fingerprints
    assert fp["format"] == "g2vec-delta-v1"
    assert len(fp["groups"]) == 2
    assert all(len(g["ranges"]) == fp["n_ranges"] for g in fp["groups"])
    assert os.path.basename(gen2) == "gen-000002"
    with open(os.path.join(gen2, "delta_fingerprints.json")) as f:
        assert json.load(f) == fp
    assert up1.acc_val == up1.acc_val and up1.biomarkers
    assert up1.embeddings.shape == prior["cold"].embeddings.shape


def test_noop_update_republishes_byte_identical_arrays(prior):
    cfg, bundle, wc = prior["cfg"], prior["bundle"], prior["wc"]
    up2 = inc.run_update(cfg, bundle, walk_cache=wc)
    st = up2.stats
    assert st["mode"] == "noop"
    assert st["walked_rows"] == 0 and st["ranges_rewalked"] == 0
    assert st["cache_hits"] == st["ranges_total"] > 0
    assert st["prior_generation"] == "gen-000002"
    assert up2.acc_val != up2.acc_val            # NaN: nothing trained
    gen3 = write_inventory_bundle(
        bundle, up2.embeddings, up2.genes, up2.biomarker_scores,
        {"source": "update"}, ann_nlist=4,
        extra_files={"delta_fingerprints.json": up2.fingerprints})
    assert os.path.basename(gen3) == "gen-000003"
    assert _array_bytes(prior["gen2"]) == _array_bytes(gen3)


def test_expression_only_change_skips_stage3(prior):
    cfg, bundle, wc = prior["cfg"], prior["bundle"], prior["wc"]
    data, src, dst = inc._load_inputs(cfg)
    in_csr = set()
    for i in range(2):
        s, d, _ = thresholded_edges(data.expr[data.label == i], src, dst,
                                    threshold=cfg.pcc_threshold,
                                    device="cpu")
        in_csr |= set(s.tolist()) | set(d.tolist())
    quiet = [g for gi, g in enumerate(data.gene) if gi not in in_csr]
    assert quiet, "the synthetic graph left no below-threshold gene"
    new_expr = os.path.join(prior["tmp"], "expr_perturbed.tsv")
    with open(cfg.expression_file) as f:
        lines = f.readlines()
    hit = False
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split("\t")
        if parts[0] == quiet[0]:
            parts[1] = repr(float(parts[1]) + 0.005)
            lines[i] = "\t".join(parts) + "\n"
            hit = True
    assert hit
    with open(new_expr, "w") as f:
        f.writelines(lines)
    up = inc.run_update(dataclasses.replace(cfg, expression_file=new_expr),
                        bundle, walk_cache=wc, epochs=3)
    st = up.stats
    assert st["mode"] == "expr_only"
    assert st["walked_rows"] == 0 and st["ranges_rewalked"] == 0
    assert st["cache_hits"] == st["ranges_total"]
    assert st["epochs"] == 3
    assert up.acc_val == up.acc_val and up.biomarkers


def _edge_delta_network(cfg, tmp):
    with open(cfg.network_file) as f:
        net_lines = f.readlines()
    have = set()
    for line in net_lines[1:]:
        a, b = line.split("\t")[0], line.split("\t")[1].strip()
        have |= {(a, b), (b, a)}
    added = [(f"GMOD{i:04d}", f"GMOD{j:04d}") for i in range(12)
             for j in range(i + 1, 12)
             if (f"GMOD{i:04d}", f"GMOD{j:04d}") not in have][:3]
    assert len(added) == 3, "the module graph is complete; widen the spec"
    path = os.path.join(tmp, "net_delta.tsv")
    with open(path, "w") as f:
        f.writelines(net_lines)
        for a, b in added:
            f.write(f"{a}\t{b}\n")
    return path


def test_edge_delta_rewalks_a_subset_and_holds_the_band(prior):
    cfg, bundle, wc = prior["cfg"], prior["bundle"], prior["wc"]
    cfg3 = dataclasses.replace(
        cfg, network_file=_edge_delta_network(cfg, prior["tmp"]),
        result_name=os.path.join(prior["tmp"], "out", "delta"))
    up = inc.run_update(cfg3, bundle, walk_cache=wc)
    st = up.stats
    assert st["mode"] == "delta"
    assert 0 < st["ranges_rewalked"] < st["ranges_total"]
    assert st["cache_hits"] > 0 and st["walked_rows"] > 0
    cold = run(dataclasses.replace(
        cfg3, result_name=os.path.join(prior["tmp"], "out", "cold3")),
        console=lambda s: None)
    ok, detail = inc.within_band(up.acc_val, cold.acc_val, up.biomarkers,
                                 cold.biomarkers)
    assert ok, f"the delta update left the band: {detail}"
    # within_band is the JAX package's rule.
    assert (ok, detail) == jinc.within_band(up.acc_val, cold.acc_val,
                                            up.biomarkers, cold.biomarkers)


# ---------------------------------------------------------------------------
# The fine-tune and the bootstrap against the JAX package
# ---------------------------------------------------------------------------

def test_fine_tune_matches_the_jax_warm_start_without_a_row_bucket(prior):
    cold = prior["cold"]
    n_genes, hidden = cold.embeddings.shape
    rng = np.random.default_rng(5)
    w_ih = np.array(cold.embeddings, dtype=np.float32)
    w_ho = (rng.standard_normal((hidden, 1)) / 4.0).astype(np.float32)
    kw = dict(hidden=hidden, learning_rate=0.05, max_epochs=10,
              compute_dtype="float32", seed=3)
    got = train_cbow(cold.paths, cold.labels, n_genes=n_genes, device="cpu",
                     init=CBOW(torch.from_numpy(w_ih.copy()),
                               torch.from_numpy(w_ho.copy())), **kw)
    want = jax_train(cold.paths, cold.labels, packed_genes=n_genes,
                     warm_start=(w_ih, w_ho), row_bucket=512, **kw)
    assert got.stop_epoch == want.stop_epoch
    np.testing.assert_allclose(got.w_ih, np.asarray(want.w_ih), rtol=1e-5,
                               atol=1e-6)
    assert abs(got.acc_val - float(want.acc_val)) <= 1e-6


def _jax_cfg(cfg, **kw):
    return JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(JaxConfig)
                        if hasattr(cfg, f.name) and f.name != "device"},
                     **kw)


def test_bootstrap_from_the_jax_draw_is_the_jax_update_and_both_read_the_others_fingerprints(  # noqa: E501
        prior):
    cfg = dataclasses.replace(prior["cfg"], cache_dir=None)
    jcfg = _jax_cfg(cfg)
    n_genes, hidden = prior["cold"].embeddings.shape
    base = jax_init_params(jax.random.key(0), n_genes, hidden)
    jroot = os.path.join(prior["tmp"], "jax_bundle")
    proot = os.path.join(prior["tmp"], "port_bundle")
    shutil.copytree(prior["cold_bundle"], jroot)
    shutil.copytree(prior["cold_bundle"], proot)
    want = jinc.run_update(jcfg, jroot)
    got = inc.run_update(cfg, proot, init=(np.asarray(base.w_ih),
                                           np.asarray(base.w_ho)))
    # The edge weights agree at 1e-6, not bitwise, so the graph hashes
    # (the groups' cache keys and range fingerprints) are each package's
    # own; everything else in the file is equal.
    assert {k: v for k, v in got.fingerprints.items() if k != "groups"} \
        == {k: v for k, v in want.fingerprints.items() if k != "groups"}
    assert {k: v for k, v in got.stats.items() if k != "wall_s"} == \
        {k: v for k, v in want.stats.items() if k != "wall_s"}
    np.testing.assert_allclose(got.embeddings, want.embeddings, rtol=1e-5,
                               atol=1e-6)
    assert got.genes == want.genes
    # Each package publishes its bootstrap, and the other trusts the file
    # (a delta against it, not a bootstrap): ranges whose edges carry
    # weights differing by an ulp between torch and XLA count as changed.
    jwriters.write_inventory_bundle(
        jroot, want.embeddings, want.genes, want.biomarker_scores,
        {"source": "update"},
        extra_files={"delta_fingerprints.json": want.fingerprints})
    write_inventory_bundle(
        proot, got.embeddings, got.genes, got.biomarker_scores,
        {"source": "update"},
        extra_files={"delta_fingerprints.json": got.fingerprints})
    for up in (inc.run_update(cfg, jroot), jinc.run_update(jcfg, proot)):
        assert up.stats["mode"] == "delta"
        assert up.stats["carried_rows"] == n_genes
        assert up.stats["prior_generation"] == "gen-000002"
    # A file whose graph hashes are the reader's own, published by the
    # other package's writer: no delta, the arrays read back unchanged.
    jwriters.write_inventory_bundle(
        jroot, want.embeddings, want.genes, want.biomarker_scores,
        {"source": "update"},
        extra_files={"delta_fingerprints.json": got.fingerprints})
    write_inventory_bundle(
        proot, got.embeddings, got.genes, got.biomarker_scores,
        {"source": "update"},
        extra_files={"delta_fingerprints.json": want.fingerprints})
    on_jax = inc.run_update(cfg, jroot)
    on_port = jinc.run_update(jcfg, proot)
    for up in (on_jax, on_port):
        assert up.stats["mode"] == "noop"
        assert up.stats["walked_rows"] == 0
        assert up.stats["prior_generation"] == "gen-000003"
    np.testing.assert_array_equal(on_jax.embeddings, want.embeddings)
    np.testing.assert_array_equal(on_port.embeddings, got.embeddings)


def test_update_refuses_to_fall_back_to_cpu(prior):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")
    cfg = dataclasses.replace(prior["cfg"], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inc.run_update(cfg, prior["bundle"])


# ---------------------------------------------------------------------------
# The daemon's update op
# ---------------------------------------------------------------------------

def _job(tsv, tmp, name, **overrides):
    job = dict(expression_file=tsv["expression"],
               clinical_file=tsv["clinical"], network_file=tsv["network"],
               result_name=os.path.join(str(tmp), "out", name),
               lenPath=8, numRepetition=2, sizeHiddenlayer=16, epoch=30,
               learningRate=0.05, numBiomarker=5, compute_dtype="float32",
               walker_backend="native")
    job.update(overrides)
    return job


def _daemon(tmp, state_dir=None, **opts):
    opts.setdefault("socket_path", os.path.join(str(tmp), "serve.sock"))
    return daemon.ServeDaemon(daemon.ServeOptions(
        state_dir=state_dir or os.path.join(str(tmp), "state"),
        device="cpu", **opts), console=lambda s: None)


def _result(d, job_id):
    with open(os.path.join(d.opts.state_dir, "results",
                           f"{job_id}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def served(tsv, tmp_path_factory):
    """A port daemon with a finished, published base job; and the JAX
    daemon for the admission answers."""
    tmp = tmp_path_factory.mktemp("upd_daemon")
    d = _daemon(tmp, cache_dir=os.path.join(str(tmp), "cache"), ann_nlist=4,
                metrics_jsonl=os.path.join(str(tmp), "m.jsonl"))
    ref = jdaemon.ServeDaemon(jdaemon.ServeOptions(
        socket_path=os.path.join(str(tmp), "jax.sock"),
        state_dir=os.path.join(str(tmp), "jax")), console=lambda s: None)
    ack = d.admit({"tenant": "alice", "job": _job(
        tsv, tmp, "base", epoch=16,
        variants=[{"name": "v0", "train_seed": 1}])})
    assert ack["event"] == "accepted"
    assert d.step() == 1
    jid = ack["job_id"]
    yield {"d": d, "ref": ref, "jid": jid, "key": f"{jid}/v0", "tmp": tmp,
           "root": os.path.join(d.opts.state_dir, "inventory", jid, "v0")}
    d.close()
    ref.close()


def test_daemon_update_bootstrap_then_noop_then_dedup(served, tsv):
    d, jid, tmp = served["d"], served["jid"], served["tmp"]
    upayload = {"op": "update", "job_id": jid, "variant": "v0",
                "tenant": "alice", "idem_key": "uk-1", "epochs": 3,
                "job": _job(tsv, tmp, "u1")}
    ack = d.admit(upayload)
    assert ack["event"] == "accepted" and ack["n_lanes"] == 0
    assert ack["job_id"] == protocol.idem_job_id("uk-1")
    assert d.step() == 1
    rec1 = _result(d, ack["job_id"])
    assert rec1["event"] == "job_done"
    assert rec1["update_of"] == served["key"]
    assert rec1["stats"]["mode"] == "bootstrap"
    assert rec1["stats"]["epochs"] == 3
    assert rec1["generation"] == "gen-000002"
    assert read_generation(served["root"]) == "gen-000002"
    # An exact neighbors query answers from the new generation.
    q = d.handle_query({"q": "neighbors", "job_id": jid, "variant": "v0",
                        "gene": "GMOD0001", "k": 3, "mode": "exact"})
    assert q["event"] == "query_result" and q["generation"] == "gen-000002"

    ack2 = d.admit({**upayload, "idem_key": "uk-2",
                    "job": _job(tsv, tmp, "u2")})
    assert d.step() == 1
    rec2 = _result(d, ack2["job_id"])
    assert rec2["stats"]["mode"] == "noop"
    assert rec2["stats"]["walked_rows"] == 0
    assert rec2["generation"] == "gen-000003"
    assert _array_bytes(os.path.join(served["root"], "gen-000002")) == \
        _array_bytes(os.path.join(served["root"], "gen-000003"))

    ack3 = d.admit({**upayload, "idem_key": "uk-2",
                    "job": _job(tsv, tmp, "u2b")})
    assert ack3.get("deduped") is True
    assert ack3["job_id"] == ack2["job_id"]
    assert d.step() == 0
    with open(os.path.join(str(tmp), "m.jsonl")) as f:
        evs = [json.loads(ln) for ln in f]
    ups = [e for e in evs if e["event"] == "update"]
    assert [e["mode"] for e in ups] == ["bootstrap", "noop"]
    assert [e["generation"] for e in evs if e["event"] == "republish"] == \
        ["gen-000002", "gen-000003"]
    assert {e["group"] for e in evs if e["event"] == "delta_walk"} == \
        {"g", "p"}


UPDATE_REJECTIONS = {
    "no-idem-key": lambda p: p.pop("idem_key"),
    "no-job-id": lambda p: p.pop("job_id"),
    "negative-epochs": lambda p: p.update(epochs=-1),
    "bool-epochs": lambda p: p.update(epochs=True),
    "int-variant": lambda p: p.update(variant=7),
    "variants": lambda p: p["job"].update(variants=[{"name": "v1"}]),
    "seeds": lambda p: p["job"].update(seeds=2),
    "bad-job": lambda p: p["job"].update(lenPath=0),
}


@pytest.mark.parametrize("case", sorted(UPDATE_REJECTIONS))
def test_update_admission_rejects_as_the_jax_daemon(case, served, tsv):
    d, ref, tmp = served["d"], served["ref"], served["tmp"]
    good = {"op": "update", "job_id": served["jid"], "variant": "v0",
            "tenant": "alice", "idem_key": f"uk-{case}",
            "job": _job(tsv, tmp, "ux")}
    payload = {**good, "job": dict(good["job"])}
    UPDATE_REJECTIONS[case](payload)
    got = d.admit(json.loads(json.dumps(payload)))
    want = ref.admit(json.loads(json.dumps(payload)))
    assert got == want
    assert got["event"] == "rejected" and got["error"] == "bad_job"
    assert d._queue.depth() == 0


def test_unknown_update_target_fails_fatal_at_run_time(served, tsv):
    d = served["d"]
    ack = d.admit({"op": "update", "job_id": "i" + "f" * 12,
                   "tenant": "alice", "idem_key": "uk-miss",
                   "job": _job(tsv, served["tmp"], "um")})
    assert ack["event"] == "accepted"
    assert d.step() == 0
    rec = _result(d, ack["job_id"])
    assert rec["status"] == "failed" and rec["classified"] == "fatal"
    assert rec["error"].startswith("update target: not_found")


def test_update_publish_sigkill_leaves_the_prior_generation_serving(
        tsv, tmp_path):
    """Killed at the ``update_publish`` seam (after the new generation is
    renamed in, before the pointer flips): the prior generation keeps
    serving and the journaled update runs to a clean flip on restart."""
    state = str(tmp_path / "state")
    tgt = "i" + "a" * 12
    root = os.path.join(state, "inventory", tgt, "v0")
    rng = np.random.default_rng(3)
    write_inventory_bundle(
        root, rng.standard_normal((30, 16)).astype(np.float32),
        [f"SEED{i:04d}" for i in range(30)], None, {"source": "plant"})
    ujid = protocol.idem_job_id("drill-1")
    jobs_dir = os.path.join(state, "jobs")
    os.makedirs(jobs_dir, exist_ok=True)
    with open(os.path.join(jobs_dir, f"{ujid}.json"), "w") as f:
        json.dump({"job_id": ujid, "tenant": "alice",
                   "submitted_at": time.time(),
                   "payload": {"op": "update", "job_id": tgt,
                               "variant": "v0", "idem_key": "drill-1",
                               "tenant": "alice", "epochs": 2,
                               "job": _job(tsv, tmp_path, "drill")}}, f)
    sock = str(tmp_path / "g.sock")
    argv = [sys.executable, "-m", "g2vec_tpu_torch", "serve", "--socket",
            sock, "--state-dir", state, "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop(faults.ENV_PLAN, None)
    with open(tmp_path / "daemon.log", "w") as log:
        proc = subprocess.Popen(
            argv, env={**env,
                       faults.ENV_PLAN: "stage=update_publish,kind=sigkill"},
            stdout=log, stderr=subprocess.STDOUT)
        assert proc.wait(timeout=120) == -signal.SIGKILL
        assert read_generation(root) == "gen-000001"
        assert os.path.isdir(os.path.join(root, "gen-000002"))
        assert os.path.exists(os.path.join(jobs_dir, f"{ujid}.json"))
        assert not os.path.exists(
            os.path.join(state, "results", f"{ujid}.json"))
        proc2 = subprocess.Popen(argv, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
        try:
            rec = client.poll_result(state, ujid, deadline_s=120)
            assert rec["event"] == "job_done"
            assert rec["stats"]["mode"] == "bootstrap"
            assert rec["generation"] == "gen-000003"
            assert read_generation(root) == "gen-000003"
            assert not os.path.isdir(os.path.join(root, "gen-000001"))
            assert client.wait_ready(sock, 60)
            client.shutdown(sock, timeout=60)
            assert proc2.wait(timeout=60) == 0
        finally:
            if proc2.poll() is None:
                proc2.kill()
                proc2.wait()


def test_the_router_relays_an_update_to_the_bundles_home(served, tsv,
                                                         tmp_path):
    """The bundle lives on r0: the router sends the update there (not on
    the ring), relays the daemon's events, and a resubmission of the key
    answers from the durable record."""
    fleet = tmp_path / "fleet"
    d = _daemon(tmp_path, state_dir=str(fleet / "r0" / "state"),
                socket_path=str(tmp_path / "r0.sock"),
                listen="127.0.0.1:0")
    ack = d.admit({"tenant": "alice", "job": _job(
        tsv, tmp_path, "rbase", epoch=8, variants=[{"name": "v0"}])})
    assert d.step() == 1
    jid = ack["job_id"]
    th = threading.Thread(target=d.serve_forever, daemon=True)
    th.start()
    try:
        deadline = time.time() + 30
        while d.tcp_addr is None and time.time() < deadline:
            time.sleep(0.05)
        r = router.Router(router.RouterOptions(fleet_dir=str(fleet),
                                               replicas=2),
                          console=lambda s: None)
        spec = r.fleet.replica("r0")
        spec.addr = f"{d.tcp_addr[0]}:{d.tcp_addr[1]}"
        spec.pid, spec.local = os.getpid(), True
        req = {"op": "update", "job_id": jid, "idem_key": "ru-1",
               "epochs": 2, "job": _job(tsv, tmp_path, "ru")}
        f = io.BytesIO()
        r._relay_update(f, dict(req))
        evs = [json.loads(ln) for ln in f.getvalue().splitlines()]
        assert [e["event"] for e in evs] == ["accepted", "started",
                                             "job_done"]
        assert evs[0]["replica"] == "r0"
        assert evs[-1]["update_of"] == f"{jid}/v0"
        assert evs[-1]["stats"]["mode"] == "bootstrap"
        f2 = io.BytesIO()
        r._relay_update(f2, dict(req))
        again = [json.loads(ln) for ln in f2.getvalue().splitlines()]
        assert again[0] == {"event": "accepted", "job_id": evs[0]["job_id"],
                            "deduped": True}
        assert again[1] == evs[-1]
        assert d.jobs_done == 2
    finally:
        d._stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        d.close()
