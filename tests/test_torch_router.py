"""The port's replicated-fleet front door against the JAX package's.

``g2vec_tpu_torch/serve/router.py`` imports neither torch nor jax, and
neither does ``g2vec_tpu/serve/router.py``: so most tests here run both
routers (and both health machines, lease handles and clients) on the same
inputs in one process and require the same answers.

- The hash ring: ``lookup`` of 1,000 keys through adds and removes, with
  and without a health overlay, equal to the JAX ring's.
- ``ReplicaHealth``: scripted probe sequences (the transition matrix, the
  rejoin flap, the backoff cap, the asymmetric partition, a seeded fuzz)
  give the JAX class's transitions, states and backoffs at every step.
- The lease: acquire/renew/release/handoff, expiry takeover with the
  zombie's kept epoch, a torn write, the stale-mtime backstop and a
  concurrent acquire give the JAX lease's epochs; the two packages'
  leases share one file format.
- Idempotency on the port's daemon: dedup within and across
  incarnations, the kill window between accept and journal, concurrent
  same-key submits admitted once, no auth token in the journal, explicit
  job ids; the job ids are the JAX package's.
- Placement and failover: the sticky-deadline refusal and admin drain
  (the same events as the JAX router's), a journal migrated to a
  survivor daemon with its original key and cursor (both routers, the
  same metrics events), fencing of an unverified death, a zombie leader
  that never migrates, a fenced replica kept out of the ring.
- The network side: the port daemon's TCP listener (status, auth,
  bounds), its stale-epoch matrix against the JAX daemon's, over TCP
  too, fence-marker quarantine, client address rotation and degraded
  mode (the same answers as the JAX client's).
- The router's own answers: for the same bad requests, and for
  ``status``/``ping``/HTTP, the port's router answers as the JAX
  router does.
- A replica that cannot boot (no card, no ``--device cpu``) fails the
  router's start, reported with its rc and log tail, and is not
  relaunched.
- The failover drill (slow): a streaming job killed with its replica mid
  epoch writes the port's solo run's bytes.

Jobs use ``walker_backend="native"``: the JAX package's device walker
does not run under jax 0.9 (no ``jax.experimental.enable_x64``).
"""
import ast
import io
import json
import os
import random
import signal
import socket
import threading
import time

import pytest

from g2vec_tpu.resilience import lifecycle as jlifecycle
from g2vec_tpu.serve import client as jclient
from g2vec_tpu.serve import daemon as jdaemon
from g2vec_tpu.serve import leader as jleader
from g2vec_tpu.serve import router as jrouter
from g2vec_tpu_torch.config import G2VecConfig, config_from_job
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.resilience import faults, lifecycle
from g2vec_tpu_torch.serve import client, daemon, leader, protocol, router

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)


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


def _daemon(tmp_path, state_dir=None, **opts):
    opts.setdefault("socket_path", os.path.join(str(tmp_path), "serve.sock"))
    return daemon.ServeDaemon(daemon.ServeOptions(
        state_dir=state_dir or os.path.join(str(tmp_path), "state"),
        device="cpu", **opts), console=lambda s: None)


def _serving(d):
    """Run ``d.serve_forever`` on a thread; returns (thread, tcp addr)."""
    th = threading.Thread(target=d.serve_forever, daemon=True)
    th.start()
    deadline = time.time() + 30
    while d.tcp_addr is None and time.time() < deadline:
        time.sleep(0.05)
    assert d.tcp_addr is not None, "daemon never bound its TCP listener"
    return th, f"{d.tcp_addr[0]}:{d.tcp_addr[1]}"


def _stop(d, th):
    d._stop.set()
    th.join(timeout=30)
    assert not th.is_alive()
    d.close()


def _routers(tmp_path, **opts):
    """The port's router and the JAX package's, same options, own dirs."""
    return (router.Router(router.RouterOptions(
                fleet_dir=str(tmp_path / "port"), **opts),
                console=lambda s: None),
            jrouter.Router(jrouter.RouterOptions(
                fleet_dir=str(tmp_path / "jax"), **opts),
                console=lambda s: None))


def _events(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# The hash ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vnodes", [64, 7])
def test_hash_ring_lookups_equal_jax(vnodes):
    port, ref = router.HashRing(vnodes=vnodes), jrouter.HashRing(
        vnodes=vnodes)
    keys = [f"jobkey-{i}" for i in range(1000)]

    def same(eligible=None):
        got = [port.lookup(k, eligible=eligible) for k in keys]
        assert got == [ref.lookup(k, eligible=eligible) for k in keys]
        return dict(zip(keys, got))

    for op, name in (("add", "r0"), ("add", "r1"), ("add", "r2")):
        getattr(port, op)(name)
        getattr(ref, op)(name)
        same()
    before = same()
    assert port.members() == ref.members() == ["r0", "r1", "r2"]
    port.add("r3")
    ref.add("r3")
    after = same()
    moved = [k for k in keys if after[k] != before[k]]
    assert all(after[k] == "r3" for k in moved)
    if vnodes == 64:
        assert len(moved) < 450         # ~250 expected; not a rehash
    for eligible in (["r0", "r1"], ["r2"], ["r3", "r1"], []):
        same(eligible)
    port.remove("r3")
    ref.remove("r3")
    assert same() == before
    port.remove("r1")
    ref.remove("r1")
    same()
    port.add("r1")
    ref.add("r1")
    assert same() == before
    assert port.lookup("anything", eligible=[]) is None


def test_router_join_key_affinity(tsv, tmp_path):
    r = router.Router(router.RouterOptions(
        fleet_dir=str(tmp_path / "fleet"), replicas=3),
        console=lambda s: None)
    a = {"job": _job(tsv, tmp_path, "a", train_seed=1)}
    b = {"job": _job(tsv, tmp_path, "b", train_seed=99, seed=5,
                     kmeans_seed=7)}
    other = {"job": _job(tsv, tmp_path, "c", sizeHiddenlayer=32)}
    assert r.pick_replica(a) == r.pick_replica(b)
    assert r.pick_replica(a) in ("r0", "r1", "r2")
    # Placement is the ring's lookup of the daemon's own join key.
    from g2vec_tpu_torch.config import serve_join_key

    key = repr(serve_join_key(config_from_job(a["job"], G2VecConfig())))
    assert r.pick_replica(a) == r.ring.lookup(key)
    assert r.pick_replica(other) == r.pick_replica(other)
    with pytest.raises((ValueError, TypeError)):
        r.pick_replica({"job": "nope"})


# ---------------------------------------------------------------------------
# Replica health
# ---------------------------------------------------------------------------

#: (constructor kwargs, steps); a step is ("ok", journal_depth),
#: ("fail",) or ("force",). Each script is the reference test's table.
HEALTH_SCRIPTS = {
    "transition-matrix": (dict(suspect_after=1, dead_after=3,
                               rejoin_after=2),
                          [("fail",), ("ok", 0), ("fail",), ("fail",),
                           ("fail",), ("ok", 4), ("ok", 2), ("ok", 0),
                           ("ok", 0)]),
    "rejoin-flap": (dict(dead_after=2),
                    [("fail",), ("fail",), ("ok", 0), ("fail",), ("ok", 0),
                     ("ok", 0)]),
    "force-dead": ({}, [("force",), ("force",), ("ok", 0), ("ok", 0),
                        ("ok", 1), ("ok", 0)]),
    "backoff-cap": ({}, [("fail",)] * 14 + [("ok", 0)]),
    "asymmetric-partition": (dict(suspect_after=1, dead_after=3,
                                  rejoin_after=2),
                             [("ok", 2), ("fail",), ("fail",), ("fail",),
                              ("ok", 2), ("ok", 2), ("fail",), ("ok", 0),
                              ("ok", 0)]),
    "suspect-window": (dict(suspect_after=2, dead_after=5, rejoin_after=3),
                       [("fail",), ("fail",), ("ok", 0), ("fail",),
                        ("fail",), ("fail",), ("fail",), ("fail",),
                        ("ok", 1), ("ok", 0), ("ok", 0), ("ok", 0)]),
}


def _fuzz_script(seed):
    rng = random.Random(seed)
    steps = []
    for _ in range(200):
        u = rng.random()
        steps.append(("force",) if u < 0.03 else ("fail",) if u < 0.5
                     else ("ok", rng.choice((0, 0, 1, 3))))
    return {}, steps


HEALTH_SCRIPTS.update({f"fuzz-{s}": _fuzz_script(s) for s in (0, 1)})


@pytest.mark.parametrize("case", sorted(HEALTH_SCRIPTS))
def test_replica_health_equals_jax(case):
    kwargs, steps = HEALTH_SCRIPTS[case]
    port = lifecycle.ReplicaHealth("r0", **kwargs)
    ref = jlifecycle.ReplicaHealth("r0", **kwargs)
    for i, step in enumerate(steps):
        now = float(i + 1)
        if step[0] == "force":
            got, want = port.force_dead(now=now), ref.force_dead(now=now)
        else:
            ok = step[0] == "ok"
            depth = step[1] if ok else 0
            got = port.on_probe(ok, journal_depth=depth, now=now)
            want = ref.on_probe(ok, journal_depth=depth, now=now)
        assert got == want, (case, i, step)
        assert port.snapshot() == ref.snapshot()
        assert port.in_ring == ref.in_ring
        assert port.last_transition == ref.last_transition
        for base in (0.5, 0.3):
            assert port.probe_interval(base) == ref.probe_interval(base)
    if case == "backoff-cap":
        assert port.probe_interval(0.5) == 0.5      # healthy again
    if case == "asymmetric-partition":
        assert port.state == "healthy"


def test_replica_health_states_and_validation_equal_jax():
    assert lifecycle.REPLICA_STATES == jlifecycle.REPLICA_STATES
    for kwargs in (dict(suspect_after=0), dict(suspect_after=3,
                                               dead_after=3)):
        with pytest.raises(ValueError) as e:
            lifecycle.ReplicaHealth("r", **kwargs)
        with pytest.raises(ValueError) as je:
            jlifecycle.ReplicaHealth("r", **kwargs)
        assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# The leadership lease
# ---------------------------------------------------------------------------

def _lease_handoff(mod, fleet):
    a = mod.LeaderLease(fleet, ttl_s=5.0, holder="A", settle_s=0.01)
    b = mod.LeaderLease(fleet, ttl_s=5.0, holder="B", settle_s=0.01)
    out = [a.acquire(), a.held, a.epoch, b.acquire(), b.held, a.renew(),
           a.acquire(), a.epoch]
    a.release()
    out += [a.held, b.acquire(), b.held, b.epoch]
    return out


def _lease_expiry(mod, fleet):
    a = mod.LeaderLease(fleet, ttl_s=0.2, holder="A", settle_s=0.01)
    b = mod.LeaderLease(fleet, ttl_s=0.2, holder="B", settle_s=0.01)
    out = [a.acquire(), a.epoch]
    time.sleep(0.35)
    out += [b.acquire(), b.epoch, a.renew(), a.held, a.epoch, a.bump(),
            b.bump()]
    return out


def _lease_torn(mod, fleet):
    a = mod.LeaderLease(fleet, ttl_s=5.0, holder="A", settle_s=0.01)
    out = [a.acquire(), a.bump()]
    with open(os.path.join(fleet, mod.LEASE_FILE), "w") as fh:
        fh.write('{"epoch": 99, "hol')
    st, expired = a.peek()
    out += [st, expired]
    b = mod.LeaderLease(fleet, ttl_s=5.0, holder="B", settle_s=0.01)
    return out + [b.acquire(), b.epoch]


def _lease_mtime(mod, fleet):
    path = os.path.join(fleet, mod.LEASE_FILE)
    with open(path, "w") as fh:
        json.dump({"epoch": 7, "holder": "skewed",
                   "renewed_at": time.time() + 1e6, "ttl_s": 0.2}, fh)
    old = time.time() - 60
    os.utime(path, (old, old))
    st, expired = mod.LeaderLease(fleet, ttl_s=0.2, holder="B").peek()
    out = [st.epoch, expired]
    b = mod.LeaderLease(fleet, ttl_s=5.0, holder="B", settle_s=0.01)
    out += [b.acquire(), b.epoch]
    with open(path, "w") as fh:
        json.dump({"epoch": 8, "holder": "B",
                   "renewed_at": time.time() - 60, "ttl_s": 0.2}, fh)
    out.append(b.peek()[1])
    with open(path, "w") as fh:
        json.dump({"epoch": 8, "holder": "B", "renewed_at": time.time(),
                   "ttl_s": 60.0}, fh)
    return out + [b.peek()[1]]


LEASE_CASES = {"handoff": _lease_handoff, "expiry-takeover": _lease_expiry,
               "torn-write": _lease_torn, "stale-mtime": _lease_mtime}


@pytest.mark.parametrize("case", sorted(LEASE_CASES))
def test_lease_epochs_equal_jax(case, tmp_path):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got = LEASE_CASES[case](leader, str(tmp_path / "port"))
    want = LEASE_CASES[case](jleader, str(tmp_path / "jax"))
    assert got == want
    expect = {"handoff": [True, True, 1, False, False, True, True, 1,
                          False, True, True, 2],
              "expiry-takeover": [True, 1, True, 2, False, False, 1, 0, 3],
              "torn-write": [True, 2, None, True, True, 3],
              "stale-mtime": [7, True, True, 8, True, False]}[case]
    assert got == expect


@pytest.mark.parametrize("mod", [leader, jleader], ids=["port", "jax"])
def test_lease_concurrent_acquire_single_winner(mod, tmp_path):
    leases = [mod.LeaderLease(str(tmp_path), ttl_s=5.0, holder=f"h{i}",
                              settle_s=0.05) for i in range(4)]
    barrier = threading.Barrier(len(leases))
    got = [False] * len(leases)

    def race(i):
        barrier.wait()
        got[i] = leases[i].acquire()

    threads = [threading.Thread(target=race, args=(i,))
               for i in range(len(leases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert any(got)
    survivors = [ls for ls in leases if ls.held and ls.renew()]
    assert len(survivors) == 1
    # A claimant that read the lease before a rival's write but the epoch
    # hint after it claims epoch 2: the winner's epoch is the file's.
    assert survivors[0].epoch == mod.read_lease(
        os.path.join(str(tmp_path), mod.LEASE_FILE)).epoch >= 1
    assert all(not ls.held for ls in leases if ls is not survivors[0])


def test_lease_files_are_shared_with_the_jax_lease(tmp_path):
    """One fleet dir, one lease: a port router and a JAX router see each
    other's claims, and the epoch keeps counting across them."""
    fleet = str(tmp_path)
    p = leader.LeaderLease(fleet, ttl_s=5.0, holder="P", settle_s=0.01)
    j = jleader.LeaderLease(fleet, ttl_s=5.0, holder="J", settle_s=0.01)
    assert p.acquire() and p.epoch == 1
    assert not j.acquire()
    assert j.peek()[0] == jleader.LeaseState(1, "P", j.peek()[0].renewed_at,
                                             5.0)
    assert p.bump() == 2
    p.release()
    assert j.acquire() and j.epoch == 3
    assert not p.acquire() and not p.held
    stop = threading.Event()
    stop.set()
    assert leader.wait_for_leadership(p, poll_s=0.01, stop=stop) is False


# ---------------------------------------------------------------------------
# Idempotency keys on the port's daemon
# ---------------------------------------------------------------------------

def test_idem_key_dedup_within_and_across_incarnations(tsv, tmp_path):
    payload = {"tenant": "a", "idem_key": "k-123",
               "job": _job(tsv, tmp_path, "a1")}
    d = _daemon(tmp_path)
    try:
        ack = d.admit(dict(payload))
        assert ack["event"] == "accepted"
        assert ack["job_id"] == jdaemon.idem_job_id("k-123")
        again = d.admit(dict(payload))
        assert (again["event"], again["job_id"], again.get("deduped")) \
            == ("accepted", ack["job_id"], True)
        assert len(os.listdir(os.path.join(d.opts.state_dir, "jobs"))) == 1
    finally:
        d.close()
    d2 = _daemon(tmp_path)
    try:
        again = d2.admit(dict(payload))
        assert again.get("deduped") is True
        assert again["job_id"] == ack["job_id"]
    finally:
        d2.close()


def test_idem_key_closes_the_kill_window_between_accept_and_journal(
        tsv, tmp_path, monkeypatch):
    payload = {"tenant": "a", "idem_key": "k-window",
               "job": _job(tsv, tmp_path, "w1")}
    d = _daemon(tmp_path)
    monkeypatch.setattr(daemon.ServeDaemon, "_journal",
                        lambda self, job: None)     # dies before the write
    try:
        ack = d.admit(dict(payload))
        assert ack["event"] == "accepted"
        assert os.listdir(os.path.join(d.opts.state_dir, "jobs")) == []
    finally:
        d.close()
    monkeypatch.undo()
    d2 = _daemon(tmp_path)
    try:
        ack2 = d2.admit(dict(payload))
        assert ack2.get("deduped") is None
        assert ack2["job_id"] == ack["job_id"] == protocol.idem_job_id(
            "k-window")
        assert d2.admit(dict(payload)).get("deduped") is True
    finally:
        d2.close()


def test_concurrent_same_key_submits_admit_exactly_once(tsv, tmp_path):
    d = _daemon(tmp_path)
    n = 8
    barrier = threading.Barrier(n)
    results = [None] * n

    def hammer(i):
        payload = {"tenant": "a", "idem_key": "k-race",
                   "job": _job(tsv, tmp_path, "race")}
        barrier.wait()
        results[i] = d.admit(payload)

    try:
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert all(r is not None and r["event"] == "accepted"
                   for r in results)
        assert len({r["job_id"] for r in results}) == 1
        assert len([r for r in results if not r.get("deduped")]) == 1
        assert len(os.listdir(os.path.join(d.opts.state_dir, "jobs"))) == 1
    finally:
        d.close()


def test_journal_never_persists_auth_token(tsv, tmp_path):
    d = _daemon(tmp_path, auth_token="sekrit-token")
    try:
        ack = d.admit({"op": "submit", "auth_token": "sekrit-token",
                       "tenant": "a", "idem_key": "k-tok",
                       "job": _job(tsv, tmp_path, "tok")})
        assert ack["event"] == "accepted"
        with open(os.path.join(d.opts.state_dir, "jobs",
                               f"{ack['job_id']}.json")) as f:
            text = f.read()
        assert "sekrit-token" not in text
        assert "auth_token" not in json.loads(text)["payload"]
    finally:
        d.close()


def test_explicit_job_ids_and_bad_keys_reject_as_the_jax_daemon(tsv,
                                                                 tmp_path):
    d = _daemon(tmp_path)
    ref = jdaemon.ServeDaemon(jdaemon.ServeOptions(
        socket_path=str(tmp_path / "jax.sock"),
        state_dir=str(tmp_path / "jax")), console=lambda s: None)
    try:
        payload = {"tenant": "a", "job_id": "j0007-deadbeef",
                   "job": _job(tsv, tmp_path, "kl")}
        assert d.admit(dict(payload))["job_id"] == "j0007-deadbeef"
        again = d.admit(dict(payload))
        assert (again["job_id"], again.get("deduped")) == (
            "j0007-deadbeef", True)
        for bad in ("../escape", ".hidden", "a/b", "", "x" * 200, 7):
            p = {"job_id": bad, "job": _job(tsv, tmp_path, "kl2")}
            got, want = d.admit(dict(p)), ref.admit(dict(p))
            assert got == want and got["event"] == "rejected"
            assert "job_id" in got["detail"]
        for bad in ("", "x" * 200, 7):
            p = {"idem_key": bad, "job": _job(tsv, tmp_path, "x")}
            got, want = d.admit(dict(p)), ref.admit(dict(p))
            assert got == want and "idem_key" in got["detail"]
        both = d.admit({"idem_key": "k-boss", "job_id": "jignored-00",
                        "job": _job(tsv, tmp_path, "kl3")})
        assert both["job_id"] == jdaemon.idem_job_id("k-boss")
    finally:
        d.close()
        ref.close()


# ---------------------------------------------------------------------------
# Placement, drain and failover
# ---------------------------------------------------------------------------

def _drain_events(f):
    f.seek(0)
    return [json.loads(line) for line in f.read().splitlines()]


def test_sticky_deadline_rejects_as_the_jax_router(tsv, tmp_path):
    """A key journaled on an unrecovered replica is refused with
    retry_later when the sticky wait runs out, never ring-placed; a fresh
    key takes the ring and, with no replica up, gets no_replicas."""
    answers = []
    for r in _routers(tmp_path, replicas=2, sticky_deadline_s=0.6):
        jid = protocol.idem_job_id("k-stuck")
        jdir = os.path.join(r.opts.fleet_dir, "r0", "state", "jobs")
        os.makedirs(jdir)
        with open(os.path.join(jdir, f"{jid}.json"), "w") as fh:
            json.dump({"job_id": jid, "submitted_at": 1.0,
                       "payload": {"idem_key": "k-stuck"}}, fh)
        f = io.BytesIO()
        r._relay_submit(f, {"op": "submit", "idem_key": "k-stuck",
                            "job": _job(tsv, tmp_path, "stuck")})
        f2 = io.BytesIO()
        r._relay_submit(f2, {"op": "submit", "idem_key": "k-fresh",
                             "job": _job(tsv, tmp_path, "fresh")})
        assert os.listdir(jdir) == [f"{jid}.json"]
        answers.append((_drain_events(f), _drain_events(f2)))
    (stuck, fresh), (jstuck, jfresh) = answers
    assert stuck == jstuck
    # The fresh key's ring order follows each package's own join key.
    assert [(e["event"], e["error"]) for e in fresh] == \
        [(e["event"], e["error"]) for e in jfresh]
    for e in (fresh[-1], jfresh[-1]):
        assert "'r0'" in e["detail"] and "'r1'" in e["detail"]
    assert stuck[-1]["error"] == "retry_later"
    assert stuck[-1]["job_id"] == protocol.idem_job_id("k-stuck")
    assert "r0" in stuck[-1]["detail"]
    assert fresh[-1]["error"] == "no_replicas"


def test_admin_drain_suppresses_failover(tmp_path):
    for r in _routers(tmp_path, replicas=2):
        with r._hlock:
            r._admin_draining.add("r0")
        assert r._failover("r0") == 0
        resp = r.handle_drain_replica("r0")
        assert resp["event"] == "error"
        assert "already draining" in resp["error"]
        assert r._failover("r1", relaunch=False) == 0
        with r._hlock:
            r._admin_draining.discard("r0")


@pytest.mark.parametrize("which", ["port", "jax"])
def test_failover_migrates_the_journal_with_its_key_and_cursor(
        which, tsv, tmp_path):
    """r0 dies with a journaled job and a streaming cursor on disk. The
    router (the port's, or the JAX package's over the same port daemon)
    copies the cursor to the survivor r1, resubmits the job there with its
    original idem key and the survivor's relay token, unlinks r0's entry
    and records a ``failover``; r1 runs it to ``done``. A second copy of
    the entry (a crash between resubmit and unlink) is reconciled against
    r1's result by the port's router and deduped by r1 under the JAX
    package's; one with a result record on r0's own disk is reconciled
    by both. The job never runs twice."""
    mod = router if which == "port" else jrouter
    fleet = tmp_path / "fleet"
    r = mod.Router(mod.RouterOptions(fleet_dir=str(fleet), replicas=2),
                   console=lambda s: None)
    payload = {"tenant": "a", "idem_key": "k-mig",
               "job": _job(tsv, tmp_path, "mig", epoch=5)}
    dead = _daemon(tmp_path, state_dir=str(fleet / "r0" / "state"),
                   socket_path=str(tmp_path / "r0.sock"))
    ack = dead.admit(dict(payload))
    dead.close()
    jid = ack["job_id"]
    assert jid == protocol.idem_job_id("k-mig")
    with open(fleet / "r0" / "state" / "jobs" / f"{jid}.json") as f:
        journaled = json.load(f)
    cursor = fleet / "r0" / "state" / "ckpt" / f"{jid}.v"
    os.makedirs(cursor)
    (cursor / "marker").write_text("cursor")
    d = _daemon(tmp_path, state_dir=str(fleet / "r1" / "state"),
                socket_path=str(tmp_path / "r1.sock"),
                listen="127.0.0.1:0",
                metrics_jsonl=str(tmp_path / "r1.jsonl"))
    th, addr = _serving(d)
    try:
        r.fleet.replica("r1").addr = addr
        assert r._failover("r0", relaunch=False) == 1
        assert os.listdir(fleet / "r0" / "state" / "jobs") == []
        assert (fleet / "r1" / "state" / "ckpt" / f"{jid}.v"
                / "marker").read_text() == "cursor"
        rec = client.poll_result(str(fleet / "r1" / "state"), jid,
                                 deadline_s=120, interval=0.1)
        assert rec["status"] == "done"
        # The survivor trusted the relay token: the deadline clock kept
        # the original admission time.
        assert rec["submitted_at"] == journaled["submitted_at"]
        # The crash-window double.
        with open(fleet / "r0" / "state" / "jobs" / f"{jid}.json",
                  "w") as f:
            json.dump(journaled, f)
        assert r._failover("r0", relaunch=False) == (which == "jax")
        assert os.listdir(fleet / "r0" / "state" / "jobs") == []
        # A result record on the dead replica's own disk reconciles.
        with open(fleet / "r0" / "state" / "jobs" / f"{jid}.json",
                  "w") as f:
            json.dump(journaled, f)
        os.makedirs(fleet / "r0" / "state" / "results", exist_ok=True)
        with open(fleet / "r0" / "state" / "results" / f"{jid}.json",
                  "w") as f:
            json.dump(rec, f)
        assert r._failover("r0", relaunch=False) == 0
        assert os.listdir(fleet / "r0" / "state" / "jobs") == []
    finally:
        _stop(d, th)
    evs = [e for e in _events(str(fleet / "router-metrics.jsonl"))
           if e["event"].startswith("failover")]
    assert [(e["event"], e["job_id"], e.get("from_replica"),
             e.get("to_replica"), e.get("deduped")) for e in evs] == [
        ("failover", jid, "r0", "r1", False),
        # A copy whose job finished elsewhere: the JAX router resends it
        # to the survivor (deduped there only if the survivor is that
        # replica); the port's reconciles it against the result record.
        ("failover", jid, "r0", "r1", True) if which == "jax" else
        ("failover_reconciled", jid, "r0", None, None),
        ("failover_reconciled", jid, "r0", None, None)]
    done = [e for e in _events(str(tmp_path / "r1.jsonl"))
            if e["event"] == "job_state" and e.get("state") == "done"]
    assert [e["job_id"] for e in done] == [jid]


class _FakeReplica:
    """A replica's TCP listener that reads each request and then does what
    ``answer(req)`` says: a dict to send back, or None to close without
    an answer (a lost ack). Records every request."""

    def __init__(self, answer):
        self.answer, self.requests = answer, []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self.addr = "127.0.0.1:%d" % self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            f = conn.makefile("rwb")
            try:
                req = protocol.read_event(f)
                if req is not None and req.get("op") != "status":
                    self.requests.append(req)
                    ev = self.answer(req)
                    if ev is not None:
                        protocol.write_event(f, ev)
            except OSError:
                pass
            finally:
                f.close()
                conn.close()

    def close(self):
        self._srv.shutdown(socket.SHUT_RDWR)
        self._srv.close()
        self._thread.join(timeout=10)


def test_an_unacked_submit_is_never_placed_on_a_second_replica(tsv,
                                                               tmp_path):
    """The ring's owner takes a submit and journals it, but its ack is
    lost (an asymmetric partition). The port's router keeps the job on
    that replica until it answers or is fenced: it never sends it to the
    successor, which would run it a second time. A replica that answers
    ``fenced`` admitted nothing, and the successor gets the job."""
    r = router.Router(router.RouterOptions(
        fleet_dir=str(tmp_path / "fleet"), replicas=2,
        sticky_deadline_s=1.5), console=lambda s: None)
    payload = {"op": "submit", "idem_key": "k-lost",
               "job": _job(tsv, tmp_path, "lost")}
    owner = r.pick_replica(payload)
    other = "r1" if owner == "r0" else "r0"
    jid = protocol.idem_job_id("k-lost")
    jdir = os.path.join(r.fleet.replica(owner).state_dir, "jobs")
    os.makedirs(jdir)

    def journal_then_drop(req):
        with open(os.path.join(jdir, f"{jid}.json"), "w") as fh:
            json.dump({"job_id": jid, "submitted_at": 1.0,
                       "payload": {k: v for k, v in req.items()
                                   if k != "op"}}, fh)
        return None

    def accept_and_finish(req):
        rdir = os.path.join(r.fleet.replica(other).state_dir, "results")
        os.makedirs(rdir, exist_ok=True)
        with open(os.path.join(rdir, f"{jid}.json"), "w") as fh:
            json.dump({"event": "job_done", "job_id": jid}, fh)
        return {"event": "accepted", "job_id": jid}

    lost = _FakeReplica(journal_then_drop)
    spare = _FakeReplica(accept_and_finish)
    try:
        r.fleet.replica(owner).addr = lost.addr
        r.fleet.replica(owner).pid = os.getpid()     # alive, unreachable
        r.fleet.replica(other).addr = spare.addr
        f = io.BytesIO()
        r._relay_submit(f, dict(payload))
        evs = _drain_events(f)
        assert evs[-1]["event"] == "rejected"
        assert evs[-1]["error"] == "retry_later"
        assert len(lost.requests) >= 2          # resent to its home
        assert spare.requests == []
        # Fenced: the owner admits nothing, so the successor is safe.
        os.unlink(os.path.join(jdir, f"{jid}.json"))
        lost.answer = lambda req: {"event": "rejected", "error": "fenced",
                                   "job_id": jid}
        f = io.BytesIO()
        r._relay_submit(f, dict(payload, idem_key="k-fenced"))
        evs = _drain_events(f)
        assert evs[0] == {"event": "accepted", "job_id": jid,
                          "replica": other}
        assert evs[-1] == {"event": "job_done", "job_id": jid}
        assert len(spare.requests) == 1
    finally:
        lost.close()
        spare.close()


def test_unverified_death_fences_before_migration(tmp_path):
    for rr, mod in zip(_routers(tmp_path, replicas=2, remote_replicas=True),
                       (leader, jleader)):
        spec = rr.fleet.replica("r0")
        assert not spec.local
        os.makedirs(spec.state_dir, exist_ok=True)
        assert rr._failover("r0") == 0
        assert mod.read_fence_marker(spec.state_dir) == 0
        assert spec.pid is None
    for rr, mod in zip(_routers(tmp_path / "local", replicas=2),
                       (leader, jleader)):
        spec = rr.fleet.replica("r0")
        os.makedirs(spec.state_dir, exist_ok=True)
        assert rr._failover("r0", relaunch=False) == 0
        assert mod.read_fence_marker(spec.state_dir) is None


def test_fence_epoch_bumps_with_lease_and_zombie_never_migrates(tmp_path):
    fleet = str(tmp_path / "fleet")
    r = router.Router(router.RouterOptions(
        fleet_dir=fleet, replicas=2, remote_replicas=True, lease_ttl_s=5.0),
        console=lambda s: None)
    assert r._lease is not None and r._lease.acquire()
    assert r.router_epoch == 1
    for name in ("r0", "r1"):
        os.makedirs(r.fleet.replica(name).state_dir, exist_ok=True)
    assert r._failover("r0", relaunch=False) == 0
    assert leader.read_fence_marker(r.fleet.replica("r0").state_dir) == 2
    assert r.router_epoch == 2
    os.unlink(os.path.join(fleet, leader.LEASE_FILE))
    usurper = jleader.LeaderLease(fleet, ttl_s=5.0, holder="U",
                                  settle_s=0.01)
    assert usurper.acquire() and usurper.epoch == 3
    assert r._failover("r1", relaunch=False) == 0
    assert leader.read_fence_marker(r.fleet.replica("r1").state_dir) is None
    assert r.router_epoch == 2


def test_probe_keeps_a_fenced_replica_out_of_the_ring(tmp_path):
    d = _daemon(tmp_path, listen="127.0.0.1:0")
    th, addr = _serving(d)
    try:
        for r in _routers(tmp_path, replicas=1, remote_replicas=True):
            r.fleet.replica("r0").addr = addr
            assert r.probe("r0")[0]
            leader.write_fence_marker(d.opts.state_dir, 4)
            assert not r.probe("r0")[0]
            leader.clear_fence_marker(d.opts.state_dir)
            assert r.probe("r0")[0]
            assert r.fleet.replica("r0").pid == os.getpid()
    finally:
        _stop(d, th)


def test_a_replica_that_cannot_boot_fails_the_router(tmp_path):
    """No ``--device cpu`` and no card: the replica exits at start, the
    router reports it with the rc and the log's no-card line, exits 1,
    and never relaunches it."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    lines = []
    r = router.Router(router.RouterOptions(
        fleet_dir=str(tmp_path / "fleet"), replicas=2,
        listen="127.0.0.1:0"), console=lines.append)
    assert r.serve_forever() == 1
    spec = r.fleet.replica("r0")
    assert spec.boots == 1 and spec.proc is None and spec.pid is None
    assert "died during boot (rc=1)" in spec.boot_error
    assert "no CUDA device" in spec.boot_error
    assert any("cannot start" in line and "no CUDA device" in line
               for line in lines)
    assert r.fleet.replica("r1").boots == 0
    assert not os.path.exists(tmp_path / "fleet" / "router_addr")
    fails = [e for e in _events(str(tmp_path / "fleet"
                                    / "router-metrics.jsonl"))
             if e["event"] == "replica_relaunch_failed"]
    assert [e["replica"] for e in fails] == ["r0"]
    # The probe loop's failover path leaves it down.
    assert r._failover("r0") == 0
    assert spec.boots == 1 and r._next_cold() is None


# ---------------------------------------------------------------------------
# The daemon's network side
# ---------------------------------------------------------------------------

def test_tcp_listener_status_auth_and_bounds(tsv, tmp_path):
    d = _daemon(tmp_path, listen="127.0.0.1:0", auth_token="sekrit",
                read_deadline_s=1.0, max_request_bytes=4096)
    th, addr = _serving(d)
    try:
        with open(os.path.join(d.opts.state_dir, "tcp_addr")) as f:
            assert f.read().strip() == addr
        with open(os.path.join(d.opts.state_dir, "serve.pid")) as f:
            assert int(f.read()) == os.getpid()
        st = client.status(addr)
        assert st["event"] == "status" and st["listen"] == addr
        assert st["journal_depth"] == 0
        assert isinstance(st["last_heartbeat_age_s"], float)
        assert client.ping(addr)["event"] == "pong"
        s = protocol.dial(addr, timeout=5.0)
        s.sendall(b"GET /status HTTP/1.0\r\n\r\n")
        http = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            http += chunk
        s.close()
        assert http.startswith(b"HTTP/1.0 200") and b"journal_depth" in http
        evs = client.submit_job(addr, _job(tsv, tmp_path, "t1"))
        assert evs[-1]["error"] == "unauthorized"
        assert os.listdir(os.path.join(d.opts.state_dir, "jobs")) == []
        evs = client.submit_job(addr, _job(tsv, tmp_path, "t2"),
                                auth_token="wrong")
        assert evs[-1]["error"] == "unauthorized"
        bad = next(client.request(addr, {"op": "cancel", "job_id": "x",
                                         "auth_token": "nope"}))
        assert bad["error"] == "unauthorized"
        s = protocol.dial(addr, timeout=5.0)
        s.sendall(b"{" + b"x" * 8192)
        assert json.loads(s.makefile("rb").readline())["error"] \
            == "oversized_request"
        s.close()
        s = protocol.dial(addr, timeout=10.0)
        t0 = time.time()
        assert s.recv(1) == b""
        assert time.time() - t0 < 8.0
        s.close()
        pend = next(client.request(addr, {"op": "result",
                                          "job_id": "nope"}))
        assert pend == {"event": "pending", "job_id": "nope",
                        "journaled": False}
    finally:
        _stop(d, th)


EPOCH_STEPS = [{}, {"router_epoch": 0}, {"router_epoch": -3},
               {"router_epoch": "5"}, {"router_epoch": True},
               {"router_epoch": 2.5}, {"router_epoch": 3},
               {"op": "cancel", "router_epoch": 3},
               {"op": "submit", "router_epoch": 2},
               {"op": "cancel", "router_epoch": 2},
               {"op": "drain", "router_epoch": 2},
               {"op": "shutdown", "router_epoch": 1},
               {"op": "status", "router_epoch": 1},
               {"op": "drain", "router_epoch": 4}]


def test_stale_epoch_matrix_equals_jax(tmp_path):
    """The same epoch stamps, in the same order, get the same answers from
    the port's daemon and the JAX daemon, and both persist the same
    watermark (a relaunched port daemon still rejects)."""
    d = _daemon(tmp_path)
    ref = jdaemon.ServeDaemon(jdaemon.ServeOptions(
        socket_path=str(tmp_path / "jax.sock"),
        state_dir=str(tmp_path / "jax")), console=lambda s: None)
    try:
        for step in EPOCH_STEPS:
            req = dict({"op": "submit"}, **step)
            assert d._observe_epoch(dict(req)) == ref._observe_epoch(
                dict(req)), step
        path = os.path.join(d.opts.state_dir, leader.ROUTER_EPOCH_FILE)
        assert leader.read_epoch_file(path) == 4 == jleader.read_epoch_file(
            os.path.join(ref.opts.state_dir, jleader.ROUTER_EPOCH_FILE))
    finally:
        d.close()
        ref.close()
    d2 = _daemon(tmp_path)
    try:
        rej = d2._observe_epoch({"op": "drain", "router_epoch": 3})
        assert rej["error"] == "stale_epoch" and rej["seen_epoch"] == 4
    finally:
        d2.close()


def test_stale_epoch_gate_over_tcp_mutators_only(tmp_path):
    d = _daemon(tmp_path, listen="127.0.0.1:0")
    th, addr = _serving(d)
    try:
        ev = next(client.request(addr, {"op": "cancel", "job_id": "x",
                                        "router_epoch": 5}))
        assert ev.get("error") != "stale_epoch"
        for req in ({"op": "cancel", "job_id": "x", "router_epoch": 4},
                    {"op": "drain", "router_epoch": 1},
                    {"op": "shutdown", "router_epoch": 2},
                    {"op": "submit", "router_epoch": 3, "job": {}}):
            ev = next(client.request(addr, req))
            assert (ev["event"], ev["error"], ev["seen_epoch"]) == (
                "rejected", "stale_epoch", 5), req
        st = next(client.request(addr, {"op": "status",
                                        "router_epoch": 1}))
        assert st["router_epoch"] == 5 and st["fenced"] is False
        assert next(client.request(addr, {"op": "ping"}))["event"] == "pong"
        assert next(client.request(addr, {"op": "result",
                                          "job_id": "nope"}))["event"] \
            == "pending"
    finally:
        _stop(d, th)


def test_fence_marker_quarantines_the_daemon(tsv, tmp_path):
    d = _daemon(tmp_path)
    try:
        assert d.admit({"tenant": "a", "idem_key": "k-parked",
                        "job": _job(tsv, tmp_path, "q1")})["event"] \
            == "accepted"
        leader.write_fence_marker(d.opts.state_dir, 9)
        rej = d.admit({"tenant": "a", "idem_key": "k-after-fence",
                       "job": _job(tsv, tmp_path, "q2")})
        assert rej["event"] == "rejected" and rej["error"] == "fenced"
        assert d.step(timeout=0.05) == 0
        assert len(os.listdir(os.path.join(d.opts.state_dir, "jobs"))) == 1
        rdir = os.path.join(d.opts.state_dir, "results")
        assert not os.path.isdir(rdir) or os.listdir(rdir) == []
        st = d.status()
        assert st["fenced"] is True and st["router_epoch"] == 9
        assert d._observe_epoch({"op": "submit", "router_epoch": 8})[
            "error"] == "stale_epoch"
        # The JAX package's marker reader agrees with the port's writer.
        assert jleader.read_fence_marker(d.opts.state_dir) == 9
        leader.clear_fence_marker(d.opts.state_dir)
        assert leader.read_fence_marker(d.opts.state_dir) is None
    finally:
        d.close()


def test_client_address_rotation_and_degraded_mode(tsv, tmp_path):
    fleet = tmp_path / "fleet"
    state = fleet / "r0" / "state"
    d = _daemon(tmp_path, listen="127.0.0.1:0", state_dir=str(state))
    th, addr = _serving(d)
    try:
        dead = "127.0.0.1:9"
        jid = protocol.idem_job_id("k-rotate")
        os.makedirs(state / "results", exist_ok=True)
        with open(state / "results" / f"{jid}.json", "w") as fh:
            json.dump({"event": "job_done", "job_id": jid}, fh)
        rec = client.poll_result_net([dead, addr], jid, deadline_s=60,
                                     interval=0.05, jitter=0.01)
        assert rec == {"event": "job_done", "job_id": jid}
        d.opts.auth_token = "gate"
        ev = client.submit_and_wait([dead, addr],
                                    _job(tsv, tmp_path, "rot"), retries=2,
                                    backoff=0.05, jitter=0.01, timeout=30)
        assert (ev["event"], ev["error"]) == ("rejected", "unauthorized")
        d.opts.auth_token = None
        f = str(fleet)
        for mod in (client, jclient):
            assert mod.fleet_addrs(f) == [addr]
            assert mod.router_addrs(f) == []
        assert client.degraded_result(f, jid) == jclient.degraded_result(
            f, jid) == {"event": "job_done", "job_id": jid,
                        "degraded": True}
        miss = "i" + "0" * 12
        assert client.degraded_result(f, miss) == jclient.degraded_result(
            f, miss)
        st = client.degraded_status(f)
        jst = jclient.degraded_status(f)
        assert {k: v for k, v in st.items() if k != "replicas"} == \
            {k: v for k, v in jst.items() if k != "replicas"}
        assert st["replicas"][addr]["event"] == "status"
        q = client.degraded_query(f, "list")
        assert q == jclient.degraded_query(f, "list")
        assert q["degraded"] is True
        evs = client.degraded_submit(f, _job(tsv, tmp_path, "deg"),
                                     idem_key="k-rotate")
        assert evs == jclient.degraded_submit(
            f, _job(tsv, tmp_path, "deg"), idem_key="k-rotate")
        assert evs[0] == {"event": "accepted", "job_id": jid,
                          "deduped": True, "degraded": True}
        empty = str(tmp_path / "nowhere")
        os.makedirs(empty)
        assert client.degraded_result(empty, "x") == jclient.degraded_result(
            empty, "x")
        assert client.degraded_result(empty, "x")["error"] == "no_replicas"
        with pytest.raises(client.ServeConnectionLost):
            client.degraded_submit(empty, _job(tsv, tmp_path, "none"),
                                   idem_key="k-none")
    finally:
        _stop(d, th)


# ---------------------------------------------------------------------------
# The router's own answers, against the JAX router's
# ---------------------------------------------------------------------------

def _ask(r, raw: bytes) -> bytes:
    a, b = socket.socketpair()
    t = threading.Thread(target=r._handle_conn, args=(a,), daemon=True)
    t.start()
    try:
        b.sendall(raw)
        b.shutdown(socket.SHUT_WR)
        out = b""
        b.settimeout(30)
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            out += chunk
        return out
    finally:
        b.close()
        t.join(timeout=30)
        assert not t.is_alive()


def _line(req) -> bytes:
    return json.dumps(req).encode() + b"\n"


ROUTER_REQUESTS = {
    "not-json": b"not json\n",
    "not-an-object": b"[1, 2]\n",
    "oversized": b"{" + b"x" * 5000,
    "unknown-op": _line({"op": "bogus"}),
    "unauthorized-submit": _line({"op": "submit", "job": {}}),
    "wrong-token-cancel": _line({"op": "cancel", "job_id": "x",
                                 "auth_token": "nope"}),
    "unauthorized-query": _line({"op": "query", "q": "list"}),
    "result-no-id": _line({"op": "result"}),
    "result-unknown": _line({"op": "result", "job_id": "inope"}),
    "cancel-no-id": _line({"op": "cancel", "auth_token": "tok"}),
    "cancel-unknown": _line({"op": "cancel", "job_id": "x",
                             "auth_token": "tok"}),
    "drain-no-name": _line({"op": "drain_replica", "auth_token": "tok"}),
    "drain-unknown": _line({"op": "drain_replica", "replica": "r9",
                            "auth_token": "tok"}),
    "submit-no-job": _line({"op": "submit", "auth_token": "tok"}),
    "submit-job-not-object": _line({"op": "submit", "job": "x",
                                    "auth_token": "tok"}),
    "submit-bad-lenpath": _line({"op": "submit", "job": {"lenPath": 3},
                                 "auth_token": "tok"}),
    "submit-no-replica": "JOB",
    "update-no-job-id": _line({"op": "update", "auth_token": "tok"}),
    "update-no-bundle": _line({"op": "update", "job_id": "inone",
                               "idem_key": "k", "auth_token": "tok"}),
    "query-list": _line({"op": "query", "q": "list", "auth_token": "tok"}),
    "query-unknown-job": _line({"op": "query", "q": "neighbors",
                                "job_id": "inone", "gene": "G1",
                                "auth_token": "tok"}),
    "fquery-bad": _line({"op": "fquery", "fq": "nope",
                         "auth_token": "tok"}),
    "http-status": b"GET /status HTTP/1.0\r\n\r\n",
    "http-unknown": b"GET /nope HTTP/1.0\r\n\r\n",
    "status": _line({"op": "status"}),
    "ping": _line({"op": "ping"}),
    "shutdown": _line({"op": "shutdown", "auth_token": "tok"}),
}


def _normalize(raw: bytes, fleet_dir: str) -> bytes:
    """The router's answers name its own pid, uptime and fleet dir."""
    text = raw.decode()
    head, sep, body = text.partition("\r\n\r\n")
    if not sep:
        head, body = "", text
    out = []
    for line in body.splitlines():
        ev = json.loads(line)
        for k in ("pid", "uptime_s"):
            ev.pop(k, None)
        if ev.get("fleet_dir") == fleet_dir:
            ev["fleet_dir"] = "FLEET"
        if ev.get("error") == "no_replicas":
            # The ring order follows each package's own join key.
            head, _, tried = ev["detail"].partition("(tried ")
            ev["detail"] = head + str(sorted(ast.literal_eval(
                tried.rstrip(")"))))
        out.append(json.dumps(ev, sort_keys=True))
    head = "\n".join(h for h in head.splitlines()
                     if not h.startswith("Content-Length"))
    return (head + "\n" + "\n".join(out)).encode()


@pytest.mark.parametrize("case", sorted(ROUTER_REQUESTS))
def test_router_answers_equal_the_jax_router(case, tsv, tmp_path):
    raw = ROUTER_REQUESTS[case]
    if raw == "JOB":
        raw = _line({"op": "submit", "auth_token": "tok",
                     "job": _job(tsv, tmp_path, "nr")})
    got = []
    for r in _routers(tmp_path, replicas=2, auth_token="tok",
                      max_request_bytes=4096, read_deadline_s=2.0):
        got.append(_normalize(_ask(r, raw), r.opts.fleet_dir))
        if case == "shutdown":
            assert r._stop.is_set()
    assert got[0] == got[1]
    assert got[0].strip()
    if case == "status":
        st = json.loads(got[0].decode().strip())
        assert st["active"] == st["ring"] == ["r0", "r1"]
        assert st["leader"] == {"enabled": False}
        assert st["replicas"]["r0"]["state"] == "healthy"


# ---------------------------------------------------------------------------
# The failover drill
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_router_failover_mid_streaming_job_byte_identical(tsv, tmp_path):
    """Two ``--device cpu`` replicas behind an in-process router; a
    streaming job's replica is SIGKILLed once its first cursor lands. The
    client's stream still ends in ``job_done``, a ``failover`` event names
    the migration, exactly one terminal ``job_state`` exists fleet-wide,
    the relaunched replica comes back healthy, and the files are the
    port's solo run's bytes."""
    from g2vec_tpu_torch.batch.engine import _variant_from_dict, lane_config
    from g2vec_tpu_torch.pipeline import run

    fleet = str(tmp_path / "fleet")
    r = router.Router(router.RouterOptions(
        fleet_dir=fleet, replicas=2, listen="127.0.0.1:0",
        probe_interval=0.3, probe_deadline=2.0,
        serve_argv=("--device", "cpu", "--cache-dir",
                    str(tmp_path / "cache"))), console=lambda s: None)
    th = threading.Thread(target=r.serve_forever, daemon=True)
    th.start()
    holder = {}
    try:
        deadline = time.time() + 300
        while r.tcp_addr is None and th.is_alive() \
                and time.time() < deadline:
            time.sleep(0.1)
        assert r.tcp_addr is not None, "router never bound"
        addr = f"{r.tcp_addr[0]}:{r.tcp_addr[1]}"
        job = _job(tsv, tmp_path, "stream1", epoch=400,
                   train_mode="streaming", shard_paths=16,
                   checkpoint_every=1)
        jid = protocol.idem_job_id("drill-1")
        sub = threading.Thread(target=lambda: holder.update(
            rec=client.submit_and_wait(addr, job, timeout=600,
                                       poll_deadline_s=600,
                                       idem_key="drill-1")), daemon=True)
        sub.start()
        victim = None
        deadline = time.time() + 240
        while victim is None and time.time() < deadline:
            for name in r.fleet.names():
                if any(e.get("job_id") == jid
                       and e.get("state") == "checkpointed"
                       for e in _events(os.path.join(fleet, name,
                                                     "metrics.jsonl"))):
                    victim = name
            time.sleep(0.05)
        assert victim is not None, "job never checkpointed"
        assert not os.path.exists(os.path.join(
            fleet, victim, "state", "results", f"{jid}.json")), \
            "job finished before the kill"
        os.kill(r.fleet.replica(victim).pid, signal.SIGKILL)
        sub.join(timeout=600)
        assert not sub.is_alive()
        rec = holder["rec"]
        assert rec["event"] == "job_done" and rec["job_id"] == jid
        evs = [e for e in _events(os.path.join(fleet,
                                               "router-metrics.jsonl"))
               if e["event"] == "failover"]
        assert any(e["job_id"] == jid and e["from_replica"] == victim
                   and e["to_replica"] != victim for e in evs), evs
        survivor = next(n for n in r.fleet.names() if n != victim)
        assert "resumed" in [
            e.get("state") for e in _events(os.path.join(
                fleet, survivor, "metrics.jsonl"))
            if e.get("job_id") == jid]
        terminal = sum(
            1 for name in r.fleet.names()
            for e in _events(os.path.join(fleet, name, "metrics.jsonl"))
            if e.get("event") == "job_state" and e.get("job_id") == jid
            and e.get("state") == "done")
        assert terminal == 1
        deadline = time.time() + 120
        while r.health[victim].state != "healthy" \
                and time.time() < deadline:
            time.sleep(0.2)
        assert r.health[victim].state == "healthy"
        assert r.fleet.replica(victim).boots == 2
    finally:
        r._stop.set()
        th.join(timeout=120)
    cfg = config_from_job(dict(job, result_name=str(tmp_path / "solo")),
                          G2VecConfig(device="cpu"))
    solo = run(lane_config(cfg, _variant_from_dict(0, {"name": "v"}, cfg)),
               console=lambda s: None)
    outs = rec["variants"]["v"]["outputs"]
    assert len(outs) == len(solo.output_files) > 0
    for a, b in zip(sorted(outs), sorted(solo.output_files)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), (a, b)
