"""The port's serve daemon (``g2vec_tpu_torch/serve``) on the CPU, against
the JAX package's.

The daemons are driven in process through ``admit``/``step`` (no
threads), except where a socket is the point. The spec is
tests/test_query.py's tiny ``SyntheticSpec``, f32, native walker, on
``--device cpu``.

- Admission: bad payloads get the JAX daemon's rejection strings; the
  job schema is the JAX package's without the fields the port has no
  counterpart for; an ``update`` op is admitted as the JAX daemon admits
  it.
- ``_FairQueue`` pops in the JAX queue's order for the same pushes.
- Two compatible jobs join one engine batch and each variant's files are
  the port's solo run's bytes; their bundles are published and queryable.
- Cancel (queued, running), deadline (queued, running), drain with the
  journal recovered by a new daemon (the same bytes), the streaming
  drain's cursor cut and resume, the ``drain`` seam.
- Over a real UNIX socket, the JAX package's client against the port's
  daemon and the port's client against the JAX daemon give the same
  event names in the same order; every socket wait has its own deadline.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from g2vec_tpu.config import config_from_job as jax_config_from_job
from g2vec_tpu.resilience import lifecycle as jlifecycle
from g2vec_tpu.serve import client as jclient
from g2vec_tpu.serve import daemon as jdaemon
from g2vec_tpu_torch.batch.engine import lane_config, plan_variants
from g2vec_tpu_torch.config import (SERVE_JOB_KEYS, G2VecConfig,
                                    config_from_job)
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.pipeline import run
from g2vec_tpu_torch.resilience import faults, lifecycle
from g2vec_tpu_torch.serve import client, daemon, inventory, protocol

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
#: The JAX package's job fields the port has no counterpart for.
NOT_IN_PORT = {"walker_batch", "walker_hbm_budget", "fused_eval",
               "epoch_superstep", "donate_state", "device_feed"}


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


def _job(tsv, tmp_path, name, **overrides):
    job = dict(expression_file=tsv["expression"],
               clinical_file=tsv["clinical"], network_file=tsv["network"],
               result_name=os.path.join(str(tmp_path), "out", name),
               lenPath=8, numRepetition=2, sizeHiddenlayer=16, epoch=30,
               learningRate=0.05, numBiomarker=5, compute_dtype="float32",
               walker_backend="native")
    job.update(overrides)
    return job


def _daemon(tmp_path, sub="state", **opts):
    return daemon.ServeDaemon(daemon.ServeOptions(
        socket_path=os.path.join(str(tmp_path), f"{sub}.sock"),
        state_dir=os.path.join(str(tmp_path), sub), device="cpu", **opts),
        console=lambda s: None)


def _result(d, job_id):
    with open(os.path.join(d.opts.state_dir, "results",
                           f"{job_id}.json")) as f:
        return json.load(f)


def _read(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def _solo_bytes(tsv, tmp_path, job, name):
    """Each variant's files from the port's solo run of its lane config."""
    base = dict(job)
    variants = base.pop("variants", None)
    seeds = base.pop("seeds", 0)
    cfg = config_from_job(
        dict(base, result_name=os.path.join(str(tmp_path), "solo", name)),
        G2VecConfig(device="cpu"))
    if seeds:
        cfg = dataclasses.replace(cfg, batch_seeds=seeds)
        planned = plan_variants(cfg)
        cfg = dataclasses.replace(cfg, batch_seeds=0)
    else:
        from g2vec_tpu_torch.batch.engine import _variant_from_dict

        planned = [_variant_from_dict(i, o, cfg) for i, o in
                   enumerate(variants or [{"name": "v"}])]
    os.makedirs(os.path.dirname(cfg.result_name), exist_ok=True)
    out = {}
    for v in planned:
        res = run(dataclasses.replace(lane_config(cfg, v),
                                      result_name=cfg.result_name + "."
                                      + v.name),
                  console=lambda s: None)
        out[v.name] = _read(res.output_files)
    return out


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def daemons(tmp_path_factory, tsv):
    tmp = tmp_path_factory.mktemp("admission")
    port = _daemon(tmp, "port")
    ref = jdaemon.ServeDaemon(jdaemon.ServeOptions(
        socket_path=str(tmp / "jax.sock"), state_dir=str(tmp / "jax")),
        console=lambda s: None)
    yield port, ref, tmp
    port.close()
    ref.close()


BAD_PAYLOADS = {
    "not-an-object": "nope",
    "no-job": {"tenant": "a"},
    "job-not-object": {"job": "nope"},
    "empty-tenant": {"tenant": "", "job": {}},
    "long-tenant": {"tenant": "t" * 65, "job": {}},
    "bad-priority": {"priority": "urgent", "job": {}},
    "negative-deadline": {"deadline_s": -1, "job": {}},
    "bool-deadline": {"deadline_s": True, "job": {}},
    "long-idem-key": {"idem_key": "k" * 129, "job": {}},
    "missing-inputs": {"job": {"lenPath": 4}},
    "bad-learning-rate": {"job": {"learningRate": -1}},
    "bad-dtype": {"job": {"compute_dtype": "float16"}},
    "seeds-and-variants": {"job": {"variants": [{}], "seeds": 2}},
    "seeds-out-of-range": {"job": {"seeds": 65}},
    "empty-variants": {"job": {"variants": []}},
    "bad-variant-key": {"job": {"variants": [{"colour": 1}]}},
    "negative-train-seed": {"job": {"variants": [{"train_seed": -2}]}},
    "duplicate-variants": {"job": {"variants": [{"name": "a"},
                                                {"name": "a"}]}},
    "too-many-variants": {"job": {"variants": [{"name": f"v{i}"}
                                               for i in range(65)]}},
    "bad-explicit-job-id": {"job_id": "../x", "job": {}},
}


@pytest.mark.parametrize("case", sorted(BAD_PAYLOADS))
def test_bad_payloads_get_the_jax_rejection(daemons, tsv, case):
    port, ref, tmp = daemons
    payload = BAD_PAYLOADS[case]
    if isinstance(payload, dict) and isinstance(payload.get("job"), dict) \
            and case not in ("missing-inputs",):
        payload = dict(payload, job={**_job(tsv, tmp, "x"),
                                     **payload["job"]})
    got, want = port.admit(payload), ref.admit(payload)
    assert got == want
    assert got["event"] == "rejected" and got["error"] == "bad_job"
    assert port._queue.depth() == ref._queue.depth() == 0


def test_job_schema_is_the_jax_schema_without_unported_fields(tsv, tmp_path):
    from g2vec_tpu.config import SERVE_JOB_KEYS as JAX_KEYS

    assert set(SERVE_JOB_KEYS) == set(JAX_KEYS) - NOT_IN_PORT
    job = _job(tsv, tmp_path, "x")
    for extra in ({"cache_dir": "/tmp/x"}, {"device": "cpu"},
                  {"device_feed": True}):
        with pytest.raises(ValueError) as e:
            config_from_job({**job, **extra})
        with pytest.raises((ValueError, TypeError)) as je:
            jax_config_from_job({**job, **extra})
        head = str(e.value).split("; allowed: ")[0]
        assert head == f"job base has unknown/forbidden key(s) " \
                       f"{sorted(extra)}"
        if not set(extra) & NOT_IN_PORT:
            assert str(je.value).split("; allowed: ")[0] == head
    with pytest.raises(ValueError) as e:
        config_from_job({"lenPath": 3})
    with pytest.raises(ValueError) as je:
        jax_config_from_job({"lenPath": 3})
    assert str(e.value) == str(je.value)
    cfg = config_from_job(job, G2VecConfig(device="cpu"))
    assert cfg.device == "cpu" and cfg.lenPath == 8


def test_update_op_rides_the_submit_pipeline(daemons, tsv, tmp_path):
    """An ``update`` payload is admitted as the JAX daemon admits it (a
    lane-less job under its idempotency key's id, over the connection
    too); a keyless one gets the JAX rejection; the CLI routes an update
    envelope to the op (exit 3: no daemon at that socket)."""
    port, ref, tmp = daemons
    payload = {"op": "update", "job_id": "i123", "idem_key": "k-up",
               "job": _job(tsv, tmp, "u")}
    got, want = port.admit(dict(payload)), ref.admit(dict(payload))
    for ack in (got, want):
        ack.pop("state_dir")
    assert got == want
    assert got["event"] == "accepted" and got["n_lanes"] == 0
    assert got["job_id"] == protocol.idem_job_id("k-up")
    assert port._queue.remove(got["job_id"]).update_of == "i123"
    ref._queue.remove(want["job_id"])
    for d in (port, ref):                 # leave the fixture's state clean
        os.unlink(os.path.join(d._jobs_dir, f"{got['job_id']}.json"))
    keyless = {k: v for k, v in payload.items() if k != "idem_key"}
    assert port.admit(dict(keyless)) == ref.admit(dict(keyless))
    rej = _roundtrip(port, keyless)
    assert rej["error"] == "bad_job" and "idem_key" in rej["detail"]
    assert port._queue.depth() == 0
    path = tmp_path / "update.json"
    path.write_text(json.dumps(payload))
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch", "serve", "--socket",
         str(tmp_path / "none.sock"), "--submit", str(path)],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 3
    assert "cannot reach daemon" in proc.stderr


def test_router_flags_are_refused(tmp_path):
    """Router mode is ported; what the JAX CLI refuses, the port's
    refuses: ``--replicas`` without ``--listen`` or below 1, and the
    ``--drain-replica`` client op without ``--socket``."""
    from g2vec_tpu.serve.cli import serve_main as jserve_main
    from g2vec_tpu_torch.serve.cli import serve_main

    for argv in (["--state-dir", str(tmp_path / "d"), "--replicas", "2"],
                 ["--state-dir", str(tmp_path / "d"), "--replicas", "0",
                  "--listen", "127.0.0.1:0"],
                 ["--drain-replica", "r1"]):
        for main in (serve_main, jserve_main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
    assert not os.path.exists(tmp_path / "d")


def test_token_bucket_and_shed_decision_equal_jax():
    for rate, burst, times in ((2.0, 3.0, (0, 0, 0, 0, 0.2, 0.6, 5.0)),
                               (0.5, 1.0, (1, 1.5, 3.0, 3.1))):
        a, b = lifecycle.TokenBucket(rate, burst), \
            jlifecycle.TokenBucket(rate, burst)
        for now in times:
            assert (a.take(now), a.retry_after(now), a.snapshot()) == \
                (b.take(now), b.retry_after(now), b.snapshot())
    for args in ((None, 3, 1.0), (5.0, 3, None), (3.0, 3, 1.0),
                 (2.0, 3, 1.0), (0.5, 10, 0.2)):
        assert lifecycle.shed_decision(*args) == \
            jlifecycle.shed_decision(*args)
    for spec in ("gold:4:8:3;*:1:2", "a:1:1"):
        assert {k: dataclasses.astuple(v) for k, v in
                daemon.parse_tenant_quotas(spec).items()} == \
            {k: dataclasses.astuple(v) for k, v in
             jdaemon.parse_tenant_quotas(spec).items()}
    for bad in ("a:1", "a:0:1", "a:1:1:0", "a:x:1", "a:1:1;a:1:1"):
        with pytest.raises(ValueError) as e:
            daemon.parse_tenant_quotas(bad)
        with pytest.raises(ValueError) as je:
            jdaemon.parse_tenant_quotas(bad)
        assert str(e.value) == str(je.value)


def test_quota_and_shed_reject_like_jax(daemons, tsv, tmp_path):
    d = _daemon(tmp_path, tenant_quotas="slow:0.001:1", shed=True)
    try:
        job = _job(tsv, tmp_path, "q")
        assert d.admit({"job": job, "tenant": "slow"})["event"] == "accepted"
        rej = d.admit({"job": job, "tenant": "slow"})
        assert rej["error"] == "tenant_quota" and rej["retry_after_s"] > 0
        with d._lock:
            d._service_times.append(10.0)
        rej = d.admit({"job": job, "deadline_s": 1.0})
        assert rej["error"] == "shed" and rej["est_wait_s"] == 10.0
        assert d.admit({"job": job, "deadline_s": 100.0})["event"] == \
            "accepted"
        # A resubmission under an idempotency key is acked once.
        first = d.admit({"job": job, "idem_key": "same"})
        again = d.admit({"job": job, "idem_key": "same"})
        assert again["job_id"] == first["job_id"] == \
            protocol.idem_job_id("same") and again["deduped"]
        assert d._queue.depth() == 3
    finally:
        d.close()


# ---------------------------------------------------------------------------
# The fair queue
# ---------------------------------------------------------------------------

def _push_and_pop(mod, weights, aging_s, pushes, aged=(), compat=None):
    q = mod._FairQueue(depth=32, aging_s=aging_s, weights=weights)
    jobs = {}
    for jid, tenant, priority, key in pushes:
        j = mod.ServeJob(job_id=jid, tenant=tenant, cfg=None, variants=[],
                         raw={}, submitted_at=0.0, priority=priority)
        j.join_key = key
        jobs[jid] = j
        q.push(j)
    for jid in aged:
        jobs[jid].queued_at -= 3600.0
    order = []
    if compat is not None:
        first = q.pop(timeout=0)
        order = [first.job_id, [j.job_id for j in q.take_compatible(
            first.join_key, compat)]]
        removed = q.remove(pushes[-1][0])
        order.append(None if removed is None else removed.job_id)
    while True:
        j = q.pop(timeout=0)
        if j is None:
            break
        order.append(j.job_id)
    return order, q.depths()


FAIR_CASES = {
    "round-robin": (None, 30.0, [
        ("a0", "a", "batch", ()), ("a1", "a", "batch", ()),
        ("a2", "a", "batch", ()), ("b0", "b", "batch", ()),
        ("c0", "c", "batch", ())], (), None),
    "weights": ({"gold": 3, "*": 1}, 30.0, [
        (f"g{i}", "gold", "batch", ()) for i in range(5)] + [
        (f"s{i}", "std", "batch", ()) for i in range(3)], (), None),
    "priority-and-aging": (None, 30.0, [
        ("j0", "t", "batch", ()), ("j1", "t", "interactive", ()),
        ("j2", "u", "batch", ()), ("j3", "u", "interactive", ()),
        ("j4", "t", "interactive", ())], ("j0", "j2"), None),
    "take-compatible": (None, 30.0, [
        ("a0", "a", "batch", ("k",)), ("a1", "a", "batch", ("other",)),
        ("b0", "b", "interactive", ("k",)), ("c0", "c", "batch", ("k",)),
        ("d0", "d", "batch", ("k",))], (), 2),
}


@pytest.mark.parametrize("case", sorted(FAIR_CASES))
def test_fair_queue_pops_in_the_jax_order(case):
    weights, aging_s, pushes, aged, compat = FAIR_CASES[case]
    got = _push_and_pop(daemon, weights, aging_s, pushes, aged, compat)
    want = _push_and_pop(jdaemon, weights, aging_s, pushes, aged, compat)
    assert got == want


def test_fair_queue_full_rejects():
    q = daemon._FairQueue(depth=1)
    q.push(daemon.ServeJob(job_id="a", tenant="t", cfg=None, variants=[],
                           raw={}, submitted_at=0.0))
    with pytest.raises(daemon.QueueFull, match="full"):
        q.push(daemon.ServeJob(job_id="b", tenant="t", cfg=None,
                               variants=[], raw={}, submitted_at=0.0))


# ---------------------------------------------------------------------------
# Joined batches, the query plane, the lifecycle
# ---------------------------------------------------------------------------

def test_two_jobs_join_one_batch_with_solo_bytes(tsv, tmp_path):
    d = _daemon(tmp_path, ann_nlist=4,
                metrics_jsonl=str(tmp_path / "m.jsonl"))
    try:
        ja = _job(tsv, tmp_path, "a", seeds=2)
        jb = _job(tsv, tmp_path, "b", variants=[
            {"name": "x", "train_seed": 5, "kmeans_seed": 2}])
        a = d.admit({"job": ja, "tenant": "alice"})
        b = d.admit({"job": jb, "tenant": "bob"})
        assert d.step(timeout=0) == 2
        ra, rb = _result(d, a["job_id"]), _result(d, b["job_id"])
        assert ra["batch"] == rb["batch"] and ra["joined_jobs"] == 2
        starts = [r for r in _metrics(tmp_path / "m.jsonl")
                  if r["event"] == "batch_start"]
        assert len(starts) == 1 and starts[0]["n_lanes"] == 3
        for rec, job, name in ((ra, ja, "a"), (rb, jb, "b")):
            solo = _solo_bytes(tsv, tmp_path, job, name)
            assert sorted(rec["variants"]) == sorted(solo)
            for v, info in rec["variants"].items():
                assert _read(info["outputs"]) == solo[v]
        # Each lane's bundle: published, manifest-verified, exact answers.
        keys = sorted(b["bundle"] for b in d.handle_query(
            {"q": "list"})["bundles"])
        assert keys == sorted([f"{a['job_id']}/s0", f"{a['job_id']}/s1",
                               f"{b['job_id']}/x"])
        with open(rb["variants"]["x"]["outputs"][2]) as f:
            gene = f.readlines()[3].split("\t")[0]
        exact = d.handle_query({"q": "neighbors", "job_id": b["job_id"],
                                "gene": gene, "k": 5, "mode": "exact"})
        cat = d.catalog.get(f"{b['job_id']}/x")
        emb = np.asarray(cat.embeddings)
        gi = list(cat.genes).index(gene)
        sims = emb @ emb[gi] / (np.asarray(cat.norms)
                                * np.sqrt(np.dot(emb[gi], emb[gi])))
        sims[gi] = -np.inf
        order = np.lexsort((np.arange(len(sims)), -sims))[:5]
        assert exact["neighbors"] == [cat.genes[i] for i in order]
        approx = d.handle_query({"q": "neighbors", "job_id": b["job_id"],
                                 "gene": gene, "k": 5, "nprobe": 4})
        assert approx["recall_mode"] == "approx" and \
            approx["neighbors"] == exact["neighbors"]
        top = d.handle_query({"q": "topk_biomarkers", "job_id": a["job_id"],
                              "variant": "s1", "k": 3})
        assert len(top["good"]["genes"]) == 3
        fq = d.handle_fquery({"fq": "gene_rank", "gene": gene, "k": 5})
        assert len(fq["bundles"]) == 3
        st = d.status()
        assert st["jobs_done"] == 2 \
            and st["inventory"]["bundles_cataloged"] == 3
        assert st["engine"]["kernel_launches"]["packed_matmul_lanes_fwd"] \
            == 0                       # the plain versions, on the CPU
        events = [r["event"] for r in _metrics(tmp_path / "m.jsonl")]
        assert events.count("inventory") == 3
        assert events.count("ann_build") == 3
    finally:
        d.close()


def _intercept(d, before):
    """Run ``before(job_ids)`` inside the engine call, as the batch starts
    executing: what a client's cancel or drain does while a job runs."""
    real = d.engine.execute

    def execute(cfg, variants, **kw):
        before(sorted(set(kw["lane_jobs"])))
        return real(cfg, variants, **kw)
    d.engine.execute = execute


def test_cancel_queued_and_running(tsv, tmp_path):
    d = _daemon(tmp_path)
    try:
        q = d.admit({"job": _job(tsv, tmp_path, "q")})
        assert d.cancel_job(q["job_id"]) == {
            "event": "cancelled", "job_id": q["job_id"], "where": "queued"}
        assert _result(d, q["job_id"])["status"] == "cancelled"
        assert d.cancel_job("nope")["event"] == "error"
        a = d.admit({"job": _job(tsv, tmp_path, "a")})
        b = d.admit({"job": _job(tsv, tmp_path, "b", seeds=2)})
        got = {}
        _intercept(d, lambda ids: got.setdefault(
            "resp", d.cancel_job(a["job_id"])))
        assert d.step(timeout=0) == 0
        assert got["resp"]["event"] == "cancelling"
        assert _result(d, a["job_id"])["status"] == "cancelled"
        # The innocent batch-mate went back to the queue and runs next.
        assert d._queue.depth() == 1
        assert d.step(timeout=0) == 1
        assert _result(d, b["job_id"])["status"] == "done"
        assert d.status()["job_states"]["cancelled"] == 2
        assert not os.listdir(os.path.join(d.opts.state_dir, "jobs"))
    finally:
        d.close()


def test_deadline_queued_and_running(tsv, tmp_path):
    d = _daemon(tmp_path)
    try:
        q = d.admit({"job": _job(tsv, tmp_path, "q"), "deadline_s": 1e-6})
        time.sleep(0.01)
        assert d.step(timeout=0) == 0
        rec = _result(d, q["job_id"])
        assert rec["status"] == "deadline_exceeded" \
            and "while queued" in rec["detail"]
        r = d.admit({"job": _job(tsv, tmp_path, "r"), "deadline_s": 3600})

        def expire(ids):
            with d._lock:
                d._running[r["job_id"]].submitted_at -= 7200
        _intercept(d, expire)
        assert d.step(timeout=0) == 0
        rec = _result(d, r["job_id"])
        assert rec["status"] == "deadline_exceeded" \
            and "while queued" not in rec["detail"]
    finally:
        d.close()


def test_drain_journals_and_a_new_daemon_writes_the_same_bytes(tsv,
                                                                tmp_path):
    import queue

    job = _job(tsv, tmp_path, "d", seeds=2)
    d = _daemon(tmp_path)
    sub = queue.Queue()
    try:
        acc = d.admit({"job": job, "tenant": "t"}, subscriber=sub)
        _intercept(d, lambda ids: d._begin_drain("test"))
        assert d.step(timeout=0) == 0
        events = []
        while not sub.empty():
            events.append(sub.get_nowait())
        assert [e["event"] for e in events if e] == ["started", "job_drained"]
        assert d.admit({"job": job})["error"] == "draining"
        assert os.path.exists(os.path.join(d.opts.state_dir, "jobs",
                                           f"{acc['job_id']}.json"))
        assert not os.path.exists(os.path.join(d.opts.state_dir, "results",
                                               f"{acc['job_id']}.json"))
    finally:
        d.close()
    d2 = _daemon(tmp_path)
    try:
        assert d2._queue.depth() == 1
        assert d2.step(timeout=0) == 1
        rec = _result(d2, acc["job_id"])
        assert rec["status"] == "done"
        solo = _solo_bytes(tsv, tmp_path, job, "d")
        for v, info in rec["variants"].items():
            assert _read(info["outputs"]) == solo[v]
        assert not os.listdir(os.path.join(d2.opts.state_dir, "jobs"))
    finally:
        d2.close()


def test_streaming_drain_cuts_a_cursor_and_resumes(tsv, tmp_path):
    job = _job(tsv, tmp_path, "s", train_mode="streaming", shard_paths=16,
               checkpoint_every=3, epoch=8, stream_patience=8)
    metrics = str(tmp_path / "m.jsonl")
    d = _daemon(tmp_path, metrics_jsonl=metrics)
    real_state = d._job_state
    seen = []

    def job_state(job_id, state, **info):
        real_state(job_id, state, **info)
        if state == "checkpointed":
            seen.append(info)
            if len(seen) == 2:
                d._begin_drain("test")
    d._job_state = job_state
    try:
        acc = d.admit({"job": job})
        assert d.step(timeout=0) == 0
    finally:
        d.close()
    jid = acc["job_id"]
    states = [r for r in _metrics(metrics)
              if r["event"] == "job_state" and r["job_id"] == jid]
    # The third cut is the drain's own, at the boundary after the second.
    cuts = [r for r in states if r["state"] == "checkpointed"]
    assert len(cuts) == 3 and states[-1]["state"] == "drained"
    assert (cuts[2]["epoch"], cuts[2]["shard"]) >= \
        (cuts[1]["epoch"], cuts[1]["shard"])
    assert os.listdir(os.path.join(str(tmp_path), "state", "ckpt",
                                   f"{jid}.v"))
    d2 = _daemon(tmp_path, metrics_jsonl=metrics)
    try:
        assert d2.step(timeout=0) == 1
        rec = _result(d2, jid)
    finally:
        d2.close()
    after = [r["state"] for r in _metrics(metrics)
             if r["event"] == "job_state" and r["job_id"] == jid]
    assert "resumed" in after and after[-1] == "done"
    solo = _solo_bytes(tsv, tmp_path, job, "s")
    assert _read(rec["variants"]["v"]["outputs"]) == solo["v"]
    # A finished job leaves no cursor behind.
    assert not os.path.exists(os.path.join(str(tmp_path), "state", "ckpt",
                                           f"{jid}.v"))


def test_drain_seam_fires_as_the_drain_begins(tmp_path):
    d = _daemon(tmp_path)
    try:
        faults.install_plan("stage=drain,kind=crash")
        with pytest.raises(faults.InjectedFault):
            d._begin_drain("test")
        assert d._draining and d._stop.is_set()
    finally:
        d.close()


def test_no_card_no_daemon(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="--device cpu"):
        daemon.ServeDaemon(daemon.ServeOptions(
            socket_path=str(tmp_path / "s"), state_dir=str(tmp_path / "d")))
    assert not os.path.exists(tmp_path / "d")
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch", "serve", "--socket",
         str(tmp_path / "s"), "--state-dir", str(tmp_path / "d")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# ---------------------------------------------------------------------------
# The socket front end
# ---------------------------------------------------------------------------

def _roundtrip(d, req, raw=None):
    """One request over the daemon's connection handler on a socketpair."""
    a, b = socket.socketpair()
    t = threading.Thread(target=d._handle_conn, args=(a,), daemon=True)
    t.start()
    f = b.makefile("rwb")
    try:
        if raw is not None:
            f.write(raw)
            f.flush()
            return f.read()
        protocol.write_event(f, req)
        return protocol.read_event(f)
    finally:
        f.close()
        b.close()
        t.join(timeout=30)


def test_connection_ops_auth_result_and_http(tsv, tmp_path):
    d = _daemon(tmp_path, auth_token="tok", max_result_bytes=4096)
    try:
        job = _job(tsv, tmp_path, "h")
        assert _roundtrip(d, {"op": "submit", "job": job})["error"] == \
            "unauthorized"
        assert _roundtrip(d, {"op": "query", "q": "list"})["error"] == \
            "unauthorized"
        assert _roundtrip(d, {"op": "ping"})["event"] == "pong"
        st = _roundtrip(d, {"op": "status"})
        assert st["event"] == "status" and st["device"] == "cpu"
        assert _roundtrip(d, {"op": "bogus"})["error"] == "unknown op 'bogus'"
        acc = d.admit({"job": job})
        assert _roundtrip(d, {"op": "result", "job_id": acc["job_id"]}) == \
            {"event": "pending", "job_id": acc["job_id"], "journaled": True}
        assert d.step(timeout=0) == 1
        rec = _roundtrip(d, {"op": "result", "job_id": acc["job_id"],
                             "fields": ["status", "tenant"]})
        assert rec == {"event": "job_done", "job_id": acc["job_id"],
                       "status": "done", "tenant": "default"}
        big = _roundtrip(d, {"op": "result", "job_id": acc["job_id"],
                             "max_bytes": 50})
        assert big["error"] == "oversized_result"
        q = _roundtrip(d, {"op": "query", "q": "list", "auth_token": "tok"})
        assert len(q["bundles"]) == 1
        http = _roundtrip(d, None, raw=b"GET /status HTTP/1.0\r\n\r\n")
        assert http.startswith(b"HTTP/1.0 200 OK")
        assert json.loads(http.split(b"\r\n\r\n", 1)[1])["jobs_done"] == 1
        stale = _roundtrip(d, {"op": "cancel", "job_id": "x",
                               "auth_token": "tok", "router_epoch": 3})
        assert stale["event"] == "error"         # unknown job, epoch 3 seen
        assert _roundtrip(d, {"op": "cancel", "job_id": "x",
                              "auth_token": "tok",
                              "router_epoch": 2})["error"] == "stale_epoch"
    finally:
        d.close()


def _serve_in_thread(d):
    t = threading.Thread(target=d.serve_forever, daemon=True)
    t.start()
    return t


def _event_names(events):
    return [e["event"] for e in events]


def test_clients_of_either_package_talk_to_either_daemon(tsv, tmp_path):
    port = _daemon(tmp_path, "port")
    ref = jdaemon.ServeDaemon(jdaemon.ServeOptions(
        socket_path=str(tmp_path / "jax.sock"),
        state_dir=str(tmp_path / "jax")), console=lambda s: None)
    threads = [_serve_in_thread(port), _serve_in_thread(ref)]
    try:
        assert client.wait_ready(port.opts.socket_path, deadline_s=30)
        assert jclient.wait_ready(ref.opts.socket_path, deadline_s=30)
        on_port = jclient.submit_job(port.opts.socket_path,
                                     _job(tsv, tmp_path, "p"),
                                     tenant="alice", timeout=120)
        on_jax = client.submit_job(ref.opts.socket_path,
                                   _job(tsv, tmp_path, "j"), tenant="bob",
                                   timeout=120)
        assert _event_names(on_port) == _event_names(on_jax) == [
            "accepted", "started", "lane_done", "job_done"]
        assert jclient.status(port.opts.socket_path)["jobs_done"] == 1
        assert client.status(ref.opts.socket_path)["jobs_done"] == 1
        assert client.query(ref.opts.socket_path, "list")["event"] == \
            jclient.query(port.opts.socket_path, "list")["event"] == \
            "query_result"
    finally:
        for d, c in ((port, client), (ref, jclient)):
            try:
                c.shutdown(d.opts.socket_path, timeout=10)
            except OSError:
                d._stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_supervise_serve_stops_on_a_clean_exit_and_a_fatal_one(tmp_path):
    from g2vec_tpu_torch.resilience.supervisor import (classify_exception,
                                                       supervise_serve)

    assert classify_exception(lifecycle.DrainRequested()) == "fatal"
    assert classify_exception(lifecycle.JobCancelled("j")) == "fatal"
    assert supervise_serve(["--help"], state_dir=str(tmp_path / "a"),
                           sleep=lambda s: None) == 0
    rc = supervise_serve(["--socket", str(tmp_path / "s"), "--state-dir",
                          str(tmp_path / "b"), "--device", "cpu",
                          "--queue-depth", "0"], retries=2,
                         metrics_jsonl=str(tmp_path / "m.jsonl"),
                         state_dir=str(tmp_path / "b"),
                         sleep=lambda s: None)
    assert rc == 1
    gave_up = [r for r in _metrics(tmp_path / "m.jsonl")
               if r["event"] == "gave_up"]
    assert len(gave_up) == 1 and gave_up[0]["attempt"] == 0 \
        and gave_up[0]["classified"] == "fatal"
    with open(tmp_path / "b" / "serve-stderr.log") as f:
        assert "--queue-depth must be >= 1" in f.read()


def test_inventory_published_bundle_verifies(tsv, tmp_path):
    """A served bundle's files are the writer's: strict manifest, and the
    JAX package's catalog opens it."""
    from g2vec_tpu.serve import inventory as jinventory

    d = _daemon(tmp_path, ann_nlist=4)
    try:
        acc = d.admit({"job": _job(tsv, tmp_path, "i")})
        assert d.step(timeout=0) == 1
    finally:
        d.close()
    root = os.path.join(str(tmp_path), "state", "inventory")
    key = f"{acc['job_id']}/v"
    ours = inventory.run_query(inventory.InventoryCatalog([root], 1 << 26),
                               "topk_biomarkers", key, k=4, mode="exact")
    theirs = jinventory.run_query(jinventory.InventoryCatalog([root],
                                                              1 << 26),
                                  "topk_biomarkers", key, k=4, mode="exact")
    assert ours == theirs
