"""The port's elastic fleet control against the JAX package's.

- ``ScalingPolicy``: the same stats sequences (square wave, sustained
  pressure, slow scale-down at the floor, the wait trip wire, the max
  guard, seeded fuzz) give the JAX class's decisions, tick by tick, and
  the same seeded victims; bad bounds raise the same errors.
- Tenant quotas and the weighted-fair queue: the port's parser and queue
  against the JAX package's.
- The client's shed backoff (a fake server, no daemon): the port's client
  retries a ``shed``/``tenant_quota`` answer under one idem key and raises
  ``ServeShed`` when the budget runs out, as the JAX client does.
- The router (no processes): the elastic state and its aggregate status,
  the static default, bound checks, the submit sanitizer, the warm-up
  canary's key, scale claims and probe targets, join-key salting, the
  promotion of a warm spare, and the fleet-stats sweep over fake
  replicas, each equal to the JAX router's.
"""
import json
import os
import random
import socket
import threading

import pytest

from g2vec_tpu.resilience import lifecycle as jlifecycle
from g2vec_tpu.serve import client as jclient
from g2vec_tpu.serve import daemon as jdaemon
from g2vec_tpu.serve import protocol as jprotocol
from g2vec_tpu.serve import router as jrouter
from g2vec_tpu_torch.resilience import lifecycle
from g2vec_tpu_torch.serve import client, daemon, protocol, router

pytestmark = pytest.mark.torch


# ---------------------------------------------------------------------------
# The scaling policy
# ---------------------------------------------------------------------------

def _fuzz_ticks(seed):
    rng = random.Random(seed)
    return [(rng.choice((0, 0, 1, 3, 8, 20)), rng.randint(1, 4),
             rng.choice((None, None, 2.0, 9.0, 30.0))) for _ in range(300)]


#: (ScalingPolicy kwargs, ticks of (queued, active, est_wait_s), the
#: reference test's expected decisions or None).
POLICY_CASES = {
    "square-wave": (dict(min_replicas=1, max_replicas=3, up_ticks=2,
                         down_ticks=6, cooldown_ticks=5),
                    [(10 if t % 2 == 0 else 0, 1, None) for t in range(40)],
                    ["hold"] * 40),
    "sustained-pressure": (dict(min_replicas=1, max_replicas=3,
                                up_queue=4.0, up_ticks=2, cooldown_ticks=5),
                           [(10, 1, None)] * 2 + [(10, 2, None)] * 6,
                           ["hold", "up"] + ["hold"] * 5 + ["up"]),
    "floor-holds": (dict(min_replicas=1, max_replicas=3, down_queue=0.5,
                         down_ticks=6, cooldown_ticks=0),
                    [(0, 1, None)] * 20, ["hold"] * 20),
    "slow-scale-down": (dict(min_replicas=1, max_replicas=3, down_ticks=6,
                             cooldown_ticks=0),
                        [(0, 2, None)] * 6, ["hold"] * 5 + ["down"]),
    "wait-signal": (dict(min_replicas=1, max_replicas=3, up_queue=4.0,
                         up_wait_s=8.0, up_ticks=2, cooldown_ticks=0),
                    [(1, 1, 30.0)] * 2, ["hold", "up"]),
    "max-guard": (dict(min_replicas=1, max_replicas=2, up_ticks=1,
                       cooldown_ticks=0), [(100, 2, None)], ["hold"]),
    "fuzz-0": (dict(min_replicas=1, max_replicas=4, seed=3),
               _fuzz_ticks(0), None),
    "fuzz-1": (dict(min_replicas=2, max_replicas=3, up_ticks=1,
                    down_ticks=2, cooldown_ticks=1), _fuzz_ticks(1), None),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_scaling_policy_decisions_equal_jax(case):
    kwargs, ticks, expect = POLICY_CASES[case]
    port = lifecycle.ScalingPolicy(**kwargs)
    ref = jlifecycle.ScalingPolicy(**kwargs)
    got = []
    for queued, active, wait in ticks:
        d = port.observe(queued, active, est_wait_s=wait)
        assert d == ref.observe(queued, active, est_wait_s=wait)
        assert port.snapshot() == ref.snapshot()
        got.append(d)
    if expect is not None:
        assert got == expect
    else:
        assert {"up", "down"} <= set(got)


def test_scaling_policy_victims_and_validation_equal_jax():
    for seed in (0, 7, 11):
        a, b = lifecycle.ScalingPolicy(1, 3, seed=seed), \
            jlifecycle.ScalingPolicy(1, 3, seed=seed)
        picks = [a.choose_victim(["r2", "r0", "r1"]) for _ in range(12)]
        assert picks == [b.choose_victim(["r0", "r1", "r2"])
                         for _ in range(12)]
        assert a.choose_victim([]) is None
    for args, kwargs in (((0, 2), {}), ((3, 2), {}),
                         ((1, 2), dict(up_queue=1.0, down_queue=1.0))):
        with pytest.raises(ValueError) as e:
            lifecycle.ScalingPolicy(*args, **kwargs)
        with pytest.raises(ValueError) as je:
            jlifecycle.ScalingPolicy(*args, **kwargs)
        assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# Tenant quotas and the weighted-fair queue
# ---------------------------------------------------------------------------

def test_parse_tenant_quotas_equals_jax():
    for spec in ("gold:4:8:3;bulk:0.5:2;*:2:4:1", None, "", "a:1:1"):
        got, want = daemon.parse_tenant_quotas(spec), \
            jdaemon.parse_tenant_quotas(spec)
        assert {k: (v.rate, v.burst, v.weight) for k, v in got.items()} \
            == {k: (v.rate, v.burst, v.weight) for k, v in want.items()}
    for bad in ("gold", "gold:4", "gold:4:8:3:9", "gold:x:8",
                "gold:4:8:1.5", "gold:0:8", "gold:4:0", "gold:4:8:0",
                ":4:8", "gold:4:8;gold:2:2"):
        with pytest.raises(ValueError) as e:
            daemon.parse_tenant_quotas(bad)
        with pytest.raises(ValueError) as je:
            jdaemon.parse_tenant_quotas(bad)
        assert str(e.value) == str(je.value)


def _order(mod, weights, pushes, n):
    q = mod._FairQueue(depth=64, aging_s=3600.0, weights=weights)
    for jid, tenant in pushes:
        q.push(mod.ServeJob(job_id=jid, tenant=tenant, cfg=None, variants=[],
                            raw={}, submitted_at=0.0))
    return [q.pop(timeout=0).tenant for _ in range(n)]


FAIR = {
    "weighted-convergence": ({"a": 3, "b": 1},
                             [(f"a{i}", "a") for i in range(24)]
                             + [(f"b{i}", "b") for i in range(8)], 32,
                             ["a", "a", "a", "b"] * 8),
    "unweighted-round-robin": (None, [(f"{t}{i}", t) for i in range(4)
                                      for t in "ab"], 8, ["a", "b"] * 4),
    "star-default-weight": ({"gold": 2, "*": 1},
                            [(f"{p}{i}", t) for i in range(6)
                             for p, t in (("g", "gold"),
                                          ("u", "unlisted"))], 9,
                            ["gold", "gold", "unlisted"] * 3),
}


@pytest.mark.parametrize("case", sorted(FAIR))
def test_fair_queue_converges_as_the_jax_queue(case):
    weights, pushes, n, expect = FAIR[case]
    got = _order(daemon, weights, pushes, n)
    assert got == _order(jdaemon, weights, pushes, n) == expect


# ---------------------------------------------------------------------------
# Client shed backoff, against a fake server
# ---------------------------------------------------------------------------

class _FakeServer:
    """A JSONL server with scripted answers, one script entry per
    connection; records each request's idem key."""

    def __init__(self, sock_path, script):
        self.script = list(script)
        self.idem_keys = []
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(sock_path)
        self._srv.listen(8)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for events in self.script:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            f = conn.makefile("rwb")
            try:
                req = protocol.read_event(f)
                self.idem_keys.append(req.get("idem_key"))
                for ev in events:
                    protocol.write_event(f, ev)
            finally:
                f.close()
                conn.close()

    def close(self):
        self._srv.close()
        self._thread.join(timeout=10)


SHED = [{"event": "rejected", "error": "shed", "job_id": "i1",
         "tenant": "gold", "retry_after_s": 0.01, "est_wait_s": 9.9}]
QUOTA = [{"event": "rejected", "error": "tenant_quota", "job_id": "i2",
          "tenant": "bulk", "retry_after_s": 0.01}]
OK = [{"event": "accepted", "job_id": "i1"},
      {"event": "job_done", "job_id": "i1", "outputs": []}]


@pytest.mark.parametrize("mod", [client, jclient], ids=["port", "jax"])
def test_client_backs_off_shed_and_reuses_the_idem_key(mod, tmp_path):
    srv = _FakeServer(str(tmp_path / "fake.sock"), [SHED, SHED, OK])
    try:
        ev = mod.submit_and_wait(str(tmp_path / "fake.sock"), {"j": 1},
                                 tenant="gold", timeout=5.0, jitter=0.0,
                                 shed_retries=3)
    finally:
        srv.close()
    assert ev["event"] == "job_done"
    assert len(srv.idem_keys) == 3 and len(set(srv.idem_keys)) == 1
    assert srv.idem_keys[0]


@pytest.mark.parametrize("mod", [client, jclient], ids=["port", "jax"])
def test_client_raises_structured_serve_shed(mod, tmp_path):
    srv = _FakeServer(str(tmp_path / "fake.sock"), [QUOTA] * 3)
    try:
        with pytest.raises(mod.ServeShed) as ei:
            mod.submit_and_wait(str(tmp_path / "fake.sock"), {"j": 1},
                                tenant="bulk", timeout=5.0, jitter=0.0,
                                shed_retries=2)
    finally:
        srv.close()
    assert (ei.value.tenant, ei.value.job_id) == ("bulk", "i2")
    assert ei.value.retry_after_s == pytest.approx(0.01)
    assert len(srv.idem_keys) == 3 and len(set(srv.idem_keys)) == 1


# ---------------------------------------------------------------------------
# The router's elastic state (no processes)
# ---------------------------------------------------------------------------

def _routers(tmp_path, **opts):
    return (router.Router(router.RouterOptions(
                fleet_dir=str(tmp_path / "port"), **opts),
                console=lambda s: None),
            jrouter.Router(jrouter.RouterOptions(
                fleet_dir=str(tmp_path / "jax"), **opts),
                console=lambda s: None))


def _status(r):
    st = r.status()
    for k in ("pid", "uptime_s", "fleet_dir"):
        st.pop(k)
    return st


def test_router_elastic_state_and_aggregate_status(tmp_path):
    port, ref = _routers(tmp_path, replicas=1, min_replicas=1,
                         max_replicas=3, warm_spares=1)
    st = _status(port)
    assert st == _status(ref)
    assert port.fleet.names() == ["r0", "r1", "r2", "r3"]
    assert st["active"] == st["ring"] == ["r0"]
    assert st["warm_pool"] == [] and st["warm_pool_size"] == 0
    assert st["autoscale"] == {"elastic": True, "min_replicas": 1,
                               "max_replicas": 3, "warm_spares": 1,
                               "up_queue": 4.0, "down_queue": 0.5,
                               "up_wait_s": 8.0, "interval_s": 1.0}
    assert st["last_scale_event"] is None and st["fleet"] == {}
    assert {n: rep["role"] for n, rep in st["replicas"].items()} == {
        "r0": "active", "r1": "cold", "r2": "cold", "r3": "cold"}
    for name in ("r2", "nope"):
        got = port.handle_drain_replica(name)
        assert got == ref.handle_drain_replica(name)
        assert got["event"] == "error"
    assert "not active" in port.handle_drain_replica("r2")["error"]


def test_router_static_default_and_bad_bounds(tmp_path):
    port, ref = _routers(tmp_path, replicas=2)
    assert _status(port) == _status(ref)
    assert port.fleet.names() == ["r0", "r1"]
    assert _status(port)["autoscale"]["elastic"] is False
    for i, opts in enumerate((dict(replicas=2, min_replicas=3,
                                   max_replicas=2),
                              dict(replicas=1, warm_spares=-1),
                              dict(replicas=1, join_spread=0))):
        with pytest.raises(ValueError) as e:
            router.Router(router.RouterOptions(
                fleet_dir=str(tmp_path / f"b{i}"), **opts),
                console=lambda s: None)
        with pytest.raises(ValueError) as je:
            jrouter.Router(jrouter.RouterOptions(
                fleet_dir=str(tmp_path / f"j{i}"), **opts),
                console=lambda s: None)
        assert str(e.value) == str(je.value)


def test_sanitize_client_submit_equals_jax():
    req = {"op": "submit", "job": {"epoch": 5}, "tenant": "gold",
           "priority": "batch", "deadline_s": 10.0, "idem_key": "k1",
           "auth_token": "fleet-secret", "requeue": True,
           "submitted_at": 1.0, "relay_token": "forged",
           "router_epoch": 9}
    out = router.sanitize_client_submit(req)
    assert out == jrouter.sanitize_client_submit(req)
    assert set(out) == {"op", "job", "tenant", "priority", "deadline_s",
                        "idem_key"}
    assert req["requeue"] is True


def test_warmup_canary_uses_a_boot_scoped_idem_key(tmp_path):
    for r in _routers(tmp_path, replicas=1, min_replicas=1, max_replicas=2,
                      warm_spares=1, auth_token="tok"):
        r.fleet.replica("r1").boots = 3
        a = r._warmup_req("r1", {"epoch": 1})
        assert a == r._warmup_req("r1", {"epoch": 1})
        assert a["idem_key"] == "warmup-r1-b3"
        assert a["auth_token"] == "tok" and a["tenant"] == "_warmup"
        assert set(a) - {"job"} <= set(protocol.SUBMIT_KEYS) \
            == set(jprotocol.SUBMIT_KEYS)
        r.fleet.replica("r1").boots = 4
        assert r._warmup_req("r1", {})["idem_key"] == "warmup-r1-b4"


def test_router_scale_claims_and_probe_targets(tmp_path):
    got = []
    for r in _routers(tmp_path, replicas=1, min_replicas=1, max_replicas=2,
                      warm_spares=1):
        seq = [r._probe_targets()]
        with r._hlock:
            r._warm.append("r1")
        seq.append(r._probe_targets())
        name, capacity = r._claim_warm()
        seq.append((name, capacity))
        with r._hlock:
            r.ring.add(name)
            r._active.add(name)
        seq += [r._claim_warm(), r._next_cold(), r._next_cold()]
        got.append(seq)
    assert got[0] == got[1] == [["r0"], ["r0", "r1"], ("r1", True),
                                (None, False), "r2", None]


def test_scale_up_promotes_a_warm_spare_as_the_jax_router(tmp_path):
    """A warm spare's promotion is a ring add: no launch, one
    ``scale_up`` and one ``warm_spare promoted`` event."""
    got = []
    for r in _routers(tmp_path, replicas=1, min_replicas=1, max_replicas=3,
                      warm_spares=1):
        with r._hlock:
            r._warm.append("r1")
        r._scale_up()
        st = _status(r)
        st["last_scale_event"].pop("at")
        st["last_scale_event"].pop("reaction_s")
        with open(os.path.join(r.opts.fleet_dir,
                               "router-metrics.jsonl")) as f:
            evs = [json.loads(line) for line in f]
        got.append((st["active"], st["ring"], st["warm_pool"],
                    st["scale_ups"], st["last_scale_event"],
                    [(e["event"], e.get("replica"), e.get("outcome"),
                      e.get("from_warm")) for e in evs]))
        assert r.fleet.replica("r1").boots == 0       # nothing launched
    assert got[0] == got[1]
    assert got[0][:4] == (["r0", "r1"], ["r0", "r1"], [], 1)
    assert got[0][5] == [("warm_spare", "r1", "promoted", None),
                         ("scale_up", "r1", None, True)]


def test_join_key_salting_bounded_spread(tmp_path):
    eligible = ["r0", "r1", "r2"]
    port, ref = _routers(tmp_path, replicas=3, join_spread=2)
    key = next(k for k in (f"hot{i}" for i in range(200))
               if port.ring.lookup(k, eligible=eligible)
               != port.ring.lookup(f"{k}#salt1", eligible=eligible))
    primary = port.ring.lookup(key, eligible=eligible)
    alt = port.ring.lookup(f"{key}#salt1", eligible=eligible)
    third = next(n for n in eligible if n not in (primary, alt))
    loaded = {"queued": 10, "running": 2}
    states = [({}, {}),
              ({"per_replica": {primary: loaded}}, {}),
              ({"per_replica": {primary: loaded, alt: loaded,
                                third: {"queued": 0, "running": 0}}}, {}),
              ({}, {f"j{i}": primary for i in range(3)})]
    picks = []
    for stats, assigned in states:
        pair = []
        for r in (port, ref):
            with r._hlock:
                r._fleet_stats = stats
                r._assigned = dict(assigned)
            pair.append(r._pick_salted(key, eligible))
        assert pair[0] == pair[1]
        picks.append(pair[0])
    assert picks == [primary, alt, primary, alt]
    one = router.Router(router.RouterOptions(
        fleet_dir=str(tmp_path / "one"), replicas=3, join_spread=1),
        console=lambda s: None)
    with one._hlock:
        one._fleet_stats = {"per_replica": {primary: {"queued": 100,
                                                      "running": 9}}}
    assert one._pick_salted(key, eligible) == primary


class _StatusReplica:
    """A fake replica: answers every request line with one status."""

    def __init__(self, status):
        self.status = status
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
                if protocol.read_event(f) is not None:
                    protocol.write_event(f, self.status)
            except OSError:
                pass
            finally:
                f.close()
                conn.close()

    def close(self):
        self._srv.shutdown(socket.SHUT_RDWR)    # wakes the accept
        self._srv.close()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()


def test_fleet_stats_sweep_equals_jax(tmp_path):
    """The scale loop's aggregate over the active set: queue and running
    totals, mean service time, the wait estimate, merged tenant ledgers,
    and a dead replica's last depth carried as pressure."""
    reps = [_StatusReplica({"event": "status", "queued": 3,
                            "running": ["a", "b"], "service_time_s": 2.0,
                            "jobs_done": 5,
                            "tenants": {"gold": {"admitted": 2, "shed": 1}}}),
            _StatusReplica({"event": "status", "queued": 1, "running": 1,
                            "service_time_s": 4.0, "jobs_done": 1,
                            "tenants": {"gold": {"admitted": 1},
                                        "bulk": {"admitted": 4}}})]
    try:
        sweeps = []
        for r in _routers(tmp_path, replicas=2):
            for name, rep in zip(("r0", "r1"), reps):
                r.fleet.replica(name).addr = rep.addr
            first = r._collect_fleet_stats()
            r.fleet.replica("r1").addr = "127.0.0.1:9"    # r1 dies
            second = r._collect_fleet_stats()
            for s in (first, second):
                s.pop("sampled_at")
            sweeps.append((first, second))
        assert sweeps[0] == sweeps[1]
        first, second = sweeps[0]
        assert (first["queued"], first["running"]) == (4, 3)
        assert first["service_time_s"] == 3.0 and first["est_wait_s"] == 6.0
        assert first["tenants"] == {"gold": {"admitted": 3, "shed": 1},
                                    "bulk": {"admitted": 4}}
        assert second["replicas_reached"] == 1 and second["queued"] == 4
        assert second["per_replica"]["r1"]["unreachable"] is True
    finally:
        for rep in reps:
            rep.close()
