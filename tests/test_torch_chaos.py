"""The port's chaos soak (``python -m g2vec_tpu_torch.tools.chaos_soak``).

Tier-1: the parser (the JAX soak's options and env fallbacks, plus
``--device``) and the partition injector (``_Relay``), each against the
JAX package's ``tools/chaos_soak.py``. Slow, as in the reference: a small
storm against one daemon, a small storm against ``--replicas 2`` behind
the router, and the partition drill, all on ``--device cpu``, with the
full acceptance (exactly-once accounting, drains exit 0, byte parity
against the port's solo runs).
"""
import json
import os
import socket
import subprocess
import sys
import threading

import pytest

from g2vec_tpu_torch.tools import chaos_soak

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_soak():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import chaos_soak as ref
    finally:
        sys.path.pop(0)
    assert ref.__file__ != chaos_soak.__file__
    return ref


def test_parser_env_fallbacks(monkeypatch):
    monkeypatch.setenv("G2V_CHAOS_JOBS", "7")
    monkeypatch.setenv("G2V_CHAOS_SEED", "3")
    monkeypatch.setenv("G2V_CHAOS_DEVICE", "cpu")
    opts = chaos_soak.build_parser().parse_args([])
    assert (opts.jobs, opts.seed, opts.device) == (7, 3, "cpu")
    opts = chaos_soak.build_parser().parse_args(["--jobs", "2", "--device",
                                                 "cuda"])
    assert (opts.jobs, opts.device) == (2, "cuda")
    assert opts.budget_s > 0 and opts.mean_arrival > 0
    monkeypatch.delenv("G2V_CHAOS_DEVICE")
    assert chaos_soak.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        chaos_soak.build_parser().parse_args(["--device", "tpu"])


@pytest.mark.parametrize("env", [{}, {"G2V_CHAOS_REPLICAS": "3",
                                      "G2V_CHAOS_AUTOSCALE": "1",
                                      "G2V_CHAOS_QUOTAS": "a:1:2",
                                      "G2V_CHAOS_BUDGET": "60"}],
                         ids=["defaults", "env"])
def test_options_equal_the_reference_soak(env, monkeypatch):
    """Every option of the JAX soak, its default and its env fallback;
    the port adds ``--device`` alone."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = vars(chaos_soak.build_parser().parse_args([]))
    ref = vars(_reference_soak().build_parser().parse_args([]))
    assert port.pop("device") == "cuda"
    assert port == ref


def test_partition_flags_env_fallbacks(monkeypatch):
    monkeypatch.setenv("G2V_CHAOS_PARTITION", "1")
    monkeypatch.setenv("G2V_CHAOS_TAKEOVERS", "2")
    monkeypatch.setenv("G2V_CHAOS_LEASE_TTL", "0.8")
    opts = chaos_soak.build_parser().parse_args([])
    assert opts.partition is True
    assert (opts.takeovers, opts.lease_ttl) == (2, 0.8)
    monkeypatch.delenv("G2V_CHAOS_PARTITION")
    opts = chaos_soak.build_parser().parse_args(["--partition"])
    assert opts.partition is True and opts.takeovers == 2


class _Echo:
    def __init__(self):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._pump, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _pump(c):
        try:
            while True:
                d = c.recv(4096)
                if not d:
                    return
                c.sendall(d)
        except OSError:
            pass
        finally:
            c.close()

    def close(self):
        self.srv.shutdown(socket.SHUT_RDWR)
        self.srv.close()
        self.thread.join(timeout=10)


def _drill(relay_cls, addr):
    """The reference test's sequence; returns what each step saw."""
    relay = relay_cls(addr)
    seen = []
    try:
        host, port = relay.addr.rsplit(":", 1)

        def rt(payload, timeout):
            c = socket.create_connection((host, int(port)), timeout=5)
            c.settimeout(timeout)
            try:
                c.sendall(payload)
                return c.recv(4096)
            except OSError as e:
                return type(e).__name__
            finally:
                c.close()

        seen.append(rt(b"ping", 5.0))
        relay.partition(to_replica=False, to_client=True)
        seen.append(rt(b"lost", 1.0))
        relay.heal()
        seen.append(rt(b"again", 5.0))
        relay.partition()
        seen.append(rt(b"void", 1.0))
        c = socket.create_connection((host, int(port)), timeout=5)
        c.close()
        seen.append("accepted")
        relay.heal()
        seen.append(rt(b"healed", 5.0))
    finally:
        relay.close()
    return seen


def test_relay_blackholes_each_direction_as_the_reference():
    echo = _Echo()
    try:
        addr = "127.0.0.1:%d" % echo.srv.getsockname()[1]
        got = _drill(chaos_soak._Relay, addr)
        assert got == _drill(_reference_soak()._Relay, addr)
    finally:
        echo.close()
    assert got == [b"ping", "TimeoutError", b"again", "TimeoutError",
                   "accepted", b"healed"]


def _soak(tmp_path, env, *argv, timeout):
    out = os.path.join(str(tmp_path), "summary.json")
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch.tools.chaos_soak",
         "--device", "cpu", "--json", out, *argv],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, **env})
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-1500:]
    with open(out) as f:
        summary = json.load(f)
    assert summary["ok"] is True
    assert summary["lost"] == [] and summary["duplicated"] == []
    assert summary["journal_leftover"] == []
    assert summary["byte_identical"] == summary["byte_checked"]
    return summary


@pytest.mark.slow
def test_chaos_soak_small_storm_accounts_every_job(tmp_path):
    s = _soak(tmp_path, {"G2V_CHAOS_JOBS": "6", "G2V_CHAOS_OPS": "3",
                         "G2V_CHAOS_EVERY": "4", "G2V_CHAOS_VERIFY": "2",
                         "G2V_CHAOS_BUDGET": "300"}, "--seed", "1",
              timeout=420)
    assert s["accepted"] == 6 and s["unsubmitted"] == 0
    assert sum(s["terminal_by_status"].values()) == 6
    assert set(s["terminal_by_status"]) <= {"done", "cancelled",
                                            "deadline_exceeded"}
    assert all(rc == 0 for rc in s["drain_exit_codes"])
    assert s["byte_checked"] == 2


@pytest.mark.slow
def test_router_soak_small_storm_accounts_every_job(tmp_path):
    s = _soak(tmp_path, {"G2V_CHAOS_JOBS": "8", "G2V_CHAOS_OPS": "4",
                         "G2V_CHAOS_VERIFY": "2", "G2V_CHAOS_BUDGET": "400"},
              "--replicas", "2", "--seed", "1", timeout=520)
    assert s["mode"] == "router" and s["accepted"] == 8
    assert s["replica_kills"] >= 1 and s["router_restarts"] >= 1
    assert all(rc in (0, None) for rc in s["drain_exit_codes"])


@pytest.mark.slow
def test_partition_drill_small_storm(tmp_path):
    s = _soak(tmp_path, {"G2V_CHAOS_JOBS": "6", "G2V_CHAOS_STREAM_FRAC": "0",
                         "G2V_CHAOS_VERIFY": "1", "G2V_CHAOS_TAKEOVERS": "1",
                         "G2V_CHAOS_BUDGET": "420"},
              "--partition", "--seed", "2", timeout=540)
    assert s["mode"] == "partition"
    assert s["fence_epoch"] >= 1
    assert s["quarantine_to_park_s"] is not None
    assert s["fenced_replica_violations"] == []
    assert s["fenced_stays_out"] is True
    assert s["stale_probe_rejects"] == s["stale_probe_targets"] > 0
    assert s["zombie_rejects"] >= 1
    assert s["takeovers"] >= 2
    assert s["degraded_submits"] >= 1
