"""The port's static-analysis suite (``python -m g2vec_tpu_torch analyze``).

Tested the way it runs, on fixture trees, case for case with the JAX
package's ``tests/test_analyze.py``: every checker gets a positive
fixture and a clean twin; the waiver and the shrink-only baseline are
pinned; the seeded ``_idem`` race is found in a copy of the port's
daemon; the lost-update regressions run on the port's daemon; and the
repo-wide gate holds the port clean with an empty baseline.

The port is held against the reference too: each mirrored fixture is
written once under ``g2vec_tpu/`` and once under ``g2vec_tpu_torch/``
(for purity with ``jax`` mapped to ``torch``), and both suites must
report the same findings once the names are mapped. The port's metrics
schema must equal the reference's.

The exit-code contract (0 clean, 1 findings, 2 usage) is checked in
fresh interpreters, and an in-process run must leave torch unimported.
"""
import ast
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

from g2vec_tpu.analyze.core import run_analysis as ref_run_analysis
from g2vec_tpu_torch.analyze.core import (load_baseline, run_analysis,
                                          save_baseline)

pytestmark = [pytest.mark.torch, pytest.mark.analyze]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "g2vec_tpu_torch"
ALL_IDS = ["lock-discipline", "torch-purity", "fault-seams",
           "metrics-schema", "config-doc-drift", "epoch-stamp"]


def _tree(tmp_path, files):
    """Write ``{relpath: source}`` under tmp_path; return the root."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return str(tmp_path)


def _port(tmp_path, files, checker):
    """The port's suite, one checker, over a fixture whose paths and
    sources name ``{pkg}`` and ``{mod}``."""
    tree = {rel.format(pkg=PKG, t="torch_"):
            src.replace("{pkg}", PKG).replace("{mod}", "torch")
            for rel, src in files.items()}
    return run_analysis(_tree(tmp_path, tree), checker_ids=[checker])


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

_LOCKED_CLASS = '''\
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []            # guarded-by: _lock

    def ok(self):
        with self._lock:
            self._items.append(1)

    def bad(self):
        self._items.append(2)
'''

_CHECK_THEN_ACT = '''\
import threading

class Table:
    def __init__(self):
        self._lock = threading.Lock()
        self._idem = {}             # guarded-by: _lock

    def admit(self, key):
        with self._lock:
            hit = self._idem.get(key)
        if hit is None:
            with self._lock:
                self._idem[key] = "fresh"
        return hit
'''

_CHECK_AND_ACT = _CHECK_THEN_ACT.replace(
    '''        with self._lock:
            hit = self._idem.get(key)
        if hit is None:
            with self._lock:
                self._idem[key] = "fresh"''',
    '''        with self._lock:
            hit = self._idem.get(key)
            if hit is None:
                self._idem[key] = "fresh"''')

_TWO_LOCKS = '''\
import threading

class TwoLocks:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self._n = 0                 # guarded-by: _a_lock

    def forward(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def backward(self):
        with self._b_lock:
            with self._a_lock:
                pass
'''

_HOLDS = '''\
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0                 # guarded-by: _lock

    # analyze: holds[_lock]
    def _bump(self):
        self._n += 1

    def good(self):
        with self._lock:
            self._bump()

    def bad(self):
        self._bump()
'''

_CONDITION = '''\
import threading

class Ring:
    def __init__(self):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._items = []            # guarded-by: _lock

    def put(self, x):
        with self._not_empty:
            self._items.append(x)
            self._not_empty.notify()
'''


def _locks(tmp_path, src, name="box.py"):
    return _port(tmp_path, {f"{{pkg}}/{name}": src}, "lock-discipline")


def test_lock_mutation_outside_lock_flagged(tmp_path):
    rep = _locks(tmp_path, _LOCKED_CLASS)
    assert len(rep.findings) == 1
    f = rep.findings[0]
    assert f.context == "Box.bad" and "_items" in f.message \
        and "without holding" in f.message
    assert f.path == f"{PKG}/box.py"


def test_lock_clean_code_is_quiet(tmp_path):
    clean = _LOCKED_CLASS.replace(
        "    def bad(self):\n        self._items.append(2)\n", "")
    rep = _locks(tmp_path, clean)
    assert rep.clean and not rep.findings


def test_waiver_suppresses_and_requires_reason(tmp_path):
    # A reasoned waiver suppresses; a bare allow[] is not a waiver.
    waived = _LOCKED_CLASS.replace(
        "        self._items.append(2)",
        "        # analyze: allow[lock-discipline] single-threaded "
        "teardown\n        self._items.append(2)")
    rep = _locks(tmp_path, waived)
    assert rep.clean and len(rep.waived) == 1

    bare = _LOCKED_CLASS.replace(
        "        self._items.append(2)",
        "        # analyze: allow[lock-discipline]\n"
        "        self._items.append(2)")
    rep2 = _locks(tmp_path / "b", bare)
    assert len(rep2.findings) == 1 and not rep2.waived


def test_baseline_suppresses_then_goes_stale(tmp_path):
    root = _tree(tmp_path, {f"{PKG}/box.py": _LOCKED_CLASS})
    base = str(tmp_path / "baseline.json")
    rep = run_analysis(root, checker_ids=["lock-discipline"])
    save_baseline(base, rep.findings)
    assert len(load_baseline(base)) == 1

    # Baselined: the finding no longer fails the run.
    rep2 = run_analysis(root, checker_ids=["lock-discipline"],
                        baseline_path=base)
    assert rep2.clean and len(rep2.baselined) == 1

    # Fix the code: the entry goes stale and FAILS (shrink-only).
    fixed = _LOCKED_CLASS.replace("        self._items.append(2)",
                                  "        pass")
    root3 = _tree(tmp_path / "fixed", {f"{PKG}/box.py": fixed})
    rep3 = run_analysis(root3, checker_ids=["lock-discipline"],
                        baseline_path=base)
    assert not rep3.clean and len(rep3.stale_baseline) == 1


def test_check_then_act_across_release(tmp_path):
    rep = _locks(tmp_path, _CHECK_THEN_ACT, "t.py")
    msgs = [f.message for f in rep.findings]
    assert any("check-then-act" in m and "_idem" in m for m in msgs)

    # The atomic form — lookup and reservation one critical section —
    # is exactly what the checker asks for, and it is quiet.
    rep2 = _locks(tmp_path / "ok", _CHECK_AND_ACT, "t.py")
    assert rep2.clean


def test_lock_order_cycle_rejected(tmp_path):
    rep = _locks(tmp_path, _TWO_LOCKS, "t.py")
    assert any("cycle" in f.message for f in rep.findings)


def test_holds_contract_enforced(tmp_path):
    rep = _locks(tmp_path, _HOLDS, "q.py")
    assert len(rep.findings) == 1
    f = rep.findings[0]
    assert f.context == "Q.bad" and "holds" in f.message


def test_condition_wrapping_lock_is_aliased(tmp_path):
    rep = _locks(tmp_path, _CONDITION, "r.py")
    assert rep.clean


def test_only_the_ports_files_are_linted(tmp_path):
    """The context lists ``g2vec_tpu_torch/``, ``chip_smoke.py`` and
    ``tests/test_torch_*.py``; the same class elsewhere is not read."""
    files = {f"{PKG}/box.py": _LOCKED_CLASS, "chip_smoke.py": _LOCKED_CLASS,
             "tests/test_torch_box.py": _LOCKED_CLASS,
             "g2vec_tpu/box.py": _LOCKED_CLASS, "box.py": _LOCKED_CLASS,
             "tests/test_box.py": _LOCKED_CLASS}
    rep = run_analysis(_tree(tmp_path, files),
                       checker_ids=["lock-discipline"])
    assert sorted(f.path for f in rep.findings) == [
        "chip_smoke.py", f"{PKG}/box.py", "tests/test_torch_box.py"]


# ---------------------------------------------------------------------------
# torch-purity
# ---------------------------------------------------------------------------

_PURITY = {
    "{pkg}/__init__.py": "",
    "{pkg}/serve/__init__.py": "",
    # Declared torch-free, but reaches torch through a helper.
    "{pkg}/serve/protocol.py": "from {pkg}.serve import helper\n",
    "{pkg}/serve/helper.py": "import {mod}\n",
}


def test_torch_free_module_reaching_torch_flagged(tmp_path):
    rep = _port(tmp_path, _PURITY, "torch-purity")
    assert any("torch" in f.message and f.path.endswith("protocol.py")
               for f in rep.findings)

    # Severing the edge makes it quiet.
    files = dict(_PURITY, **{"{pkg}/serve/helper.py": "import os\n"})
    rep2 = _port(tmp_path / "ok", files, "torch-purity")
    assert rep2.clean


def test_torch_free_closure_follows_package_inits_and_triton(tmp_path):
    """A torch import smuggled into a package ``__init__`` on the chain
    is caught; so is triton; a deferred import in a transitive dep is the
    lazy idiom and is allowed, in the declared module itself it is not."""
    files = {
        "{pkg}/__init__.py": "",
        "{pkg}/serve/__init__.py": "",
        "{pkg}/serve/router.py": "from {pkg}.util.x import f\n",
        "{pkg}/util/__init__.py": "import triton\n",
        "{pkg}/util/x.py": "def f():\n    import torch\n",
        "{pkg}/serve/leader.py":
            "def g():\n    import torch.cuda\n    return torch\n",
    }
    rep = _port(tmp_path, files, "torch-purity")
    msgs = sorted((f.path, f.message) for f in rep.findings)
    assert len(msgs) == 2, msgs
    assert msgs[0][0] == f"{PKG}/serve/leader.py" and \
        "imports torch.cuda directly" in msgs[0][1]
    assert msgs[1][0] == f"{PKG}/serve/router.py" and \
        "reaches triton at import time" in msgs[1][1] and \
        f"{PKG}/util/__init__.py" in msgs[1][1]


def test_the_suite_itself_is_declared_torch_free(tmp_path):
    files = {"{pkg}/__init__.py": "",
             "{pkg}/analyze/__init__.py": "",
             "{pkg}/analyze/cli.py": "def main():\n    import torch\n"}
    rep = _port(tmp_path, files, "torch-purity")
    assert [(f.path, f.context) for f in rep.findings] == [
        (f"{PKG}/analyze/cli.py", "main")]
    assert "declared torch-free" in rep.findings[0].message


def test_port_module_importing_jax_flagged(tmp_path):
    """No module of the port imports JAX or the JAX package, even
    deferred; the parity tests import both and are not held to it."""
    files = {
        "{pkg}/__init__.py": "",
        "{pkg}/ops.py": "import numpy\n\ndef f():\n"
                        "    from jax import numpy as jnp\n",
        "{pkg}/io.py": "from g2vec_tpu.io import readers\n",
        "chip_smoke.py": "import optax\n",
        "tests/test_torch_x.py": "import jax\nimport g2vec_tpu\n",
    }
    rep = _port(tmp_path, files, "torch-purity")
    got = sorted((f.path, f.line, f.context) for f in rep.findings)
    assert got == [("chip_smoke.py", 1, "<module>"),
                   (f"{PKG}/io.py", 1, "<module>"),
                   (f"{PKG}/ops.py", 4, "f")], got
    files = {"{pkg}/__init__.py": "", "{pkg}/ops.py": "import numpy\n",
             "tests/test_torch_x.py": "import jax\n"}
    assert _port(tmp_path / "ok", files, "torch-purity").clean


# ---------------------------------------------------------------------------
# fault-seams
# ---------------------------------------------------------------------------

_SEAMS = {
    "{pkg}/resilience/faults.py": 'SEAMS = ("alpha", "beta")\n',
    "{pkg}/core.py": '''\
from {pkg}.resilience.faults import fault_point

def work(name):
    fault_point("alpha")
    fault_point("typo_seam")
    fault_point(name)
''',
    "tests/test_{t}core.py": 'PLAN = "stage=alpha,kind=crash"\n',
}

_SEAMS_CLEAN = {
    "{pkg}/resilience/faults.py": 'SEAMS = ("alpha", "beta")\n',
    "{pkg}/core.py": '''\
from {pkg}.resilience.faults import fault_point

def work():
    fault_point("alpha")
    fault_point("beta")
''',
    "tests/test_{t}core.py": 'PLAN = "stage=alpha;stage=beta"\n',
}


def test_seam_registry_enforced(tmp_path):
    rep = _port(tmp_path, _SEAMS, "fault-seams")
    msgs = " | ".join(f.message for f in rep.findings)
    assert "typo_seam" in msgs            # undeclared literal at a call
    assert "beta" in msgs                 # declared but never called
    assert "not a string literal" in msgs
    assert f"{PKG}/resilience/faults.py" in msgs
    assert _port(tmp_path / "ok", _SEAMS_CLEAN, "fault-seams").clean


def test_seams_count_only_the_ports_call_sites_and_tests(tmp_path):
    """The JAX package's call site and its test speak the same seam; for
    the port they count for nothing."""
    files = dict(_SEAMS_CLEAN)
    files["{pkg}/core.py"] = files["{pkg}/core.py"].replace(
        '    fault_point("beta")\n', "")
    files["tests/test_{t}core.py"] = 'PLAN = "stage=alpha"\n'
    files["g2vec_tpu/core.py"] = 'fault_point("beta")\n'
    files["tests/test_core.py"] = 'PLAN = "stage=beta"\n'
    files["chip_smoke.py"] = 'fault_point("beta")\n'
    rep = _port(tmp_path, files, "fault-seams")
    msgs = sorted(f.message for f in rep.findings)
    assert len(msgs) == 2, msgs
    assert "'beta'" in msgs[0] and "no fault_point call site" in msgs[0]
    assert "'beta'" in msgs[1] and "no test references it" in msgs[1]


# ---------------------------------------------------------------------------
# metrics-schema
# ---------------------------------------------------------------------------

_EVENTS = {
    "{pkg}/utils/metrics_schema.py": '''\
EVENT_SCHEMAS = {
    "boot": {"required": ["rank"], "optional": ["note"]},
}
''',
    "{pkg}/app.py": '''\
def go(metrics, extra):
    metrics.emit("boot", rank=0, note="hi")       # clean
    metrics.emit("boot", nope=1)                  # unknown field + no rank
    metrics.emit("mystery", x=1)                  # unknown kind
    metrics.emit("boot", **extra)                 # splat: no missing check
''',
}


def test_event_schema_enforced(tmp_path):
    rep = _port(tmp_path, _EVENTS, "metrics-schema")
    msgs = [f.message for f in rep.findings]
    assert any("nope" in m for m in msgs)
    assert any("rank" in m for m in msgs)
    assert any("mystery" in m for m in msgs)
    # Exactly the three: the clean site and the splat site are quiet.
    assert len(msgs) == 3
    clean = dict(_EVENTS, **{"{pkg}/app.py": (
        "def go(metrics, extra):\n"
        "    metrics.emit('boot', rank=0, note='hi')\n"
        "    metrics.emit('boot', **extra)\n")})
    assert _port(tmp_path / "ok", clean, "metrics-schema").clean


def test_port_schema_equals_the_reference_schema():
    """The port's events are the reference's: its copy of the schema,
    read by AST as the checker reads it, is the reference's table."""
    def schemas(path):
        with open(os.path.join(REPO, path)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "EVENT_SCHEMAS"
                    for t in node.targets):
                return ast.literal_eval(node.value)
        raise AssertionError(f"{path}: EVENT_SCHEMAS not found")

    port = schemas(f"{PKG}/utils/metrics_schema.py")
    assert port == schemas("g2vec_tpu/utils/metrics_schema.py")
    assert len(port) > 50


# ---------------------------------------------------------------------------
# config-doc-drift
# ---------------------------------------------------------------------------

_FLAGS = {
    "{pkg}/config.py": '''\
def build_parser(p):
    p.add_argument("--documented-flag", type=int)
    p.add_argument("--secret-flag", type=int)
''',
    "README.md": "Use `--documented-flag N` to tune things.\n",
}

_ENVELOPES = {
    "{pkg}/config.py": '''\
SERVE_JOB_KEYS = ("lenPath", "ghost")

class G2VecConfig:
    lenPath: int = 80
''',
    "{pkg}/serve/protocol.py": '''\
SUBMIT_KEYS = ("op", "job")
UPDATE_KEYS = ("op", "job_id", "variant", "epochs")
QUERY_KEYS = ("op", "kind")
''',
    "{pkg}/serve/daemon.py": '''\
def admit(payload):
    return payload.get("job"), payload["typo"]

def _update_fields(ureq):
    return ureq.get("variant"), ureq.get("epochs"), ureq.get("nope")
''',
    "{pkg}/serve/router.py": '''\
def query(qreq):
    return qreq["kind"], qreq.get("knd")
''',
}


def test_readme_flag_drift_flagged(tmp_path):
    rep = _port(tmp_path, _FLAGS, "config-doc-drift")
    assert len(rep.findings) == 1
    assert "--secret-flag" in rep.findings[0].message

    files = dict(_FLAGS, **{"README.md": _FLAGS["README.md"]
                            + "Also `--secret-flag`.\n"})
    rep2 = _port(tmp_path / "ok", files, "config-doc-drift")
    assert rep2.clean


def test_job_keys_and_envelope_reads_held_to_the_protocol(tmp_path):
    rep = _port(tmp_path, _ENVELOPES, "config-doc-drift")
    got = sorted((f.path, f.context, f.message.split(" is ")[0])
                 for f in rep.findings)
    assert got == [
        (f"{PKG}/config.py", "<module>", "SERVE_JOB_KEYS entry 'ghost'"),
        (f"{PKG}/serve/daemon.py", "_update_fields", "ureq key 'nope'"),
        (f"{PKG}/serve/daemon.py", "admit", "payload key 'typo'"),
        (f"{PKG}/serve/router.py", "query", "qreq key 'knd'")], got
    clean = {
        "{pkg}/config.py": _ENVELOPES["{pkg}/config.py"].replace(
            '"ghost"', ""),
        "{pkg}/serve/protocol.py": _ENVELOPES["{pkg}/serve/protocol.py"],
        "{pkg}/serve/daemon.py": _ENVELOPES["{pkg}/serve/daemon.py"]
        .replace(', payload["typo"]', "").replace(', ureq.get("nope")', ""),
        "{pkg}/serve/router.py": "def query(qreq):\n    return qreq['kind']\n",
    }
    assert _port(tmp_path / "ok", clean, "config-doc-drift").clean


def test_update_envelope_drift_is_repaired(tmp_path):
    """The port's ``_update_fields`` reads the update envelope as
    ``ureq``, linted against ``UPDATE_KEYS``. Under the submit envelope's
    name (``payload``) its ``variant`` and ``epochs`` reads are drift
    against ``SUBMIT_KEYS``: the checker would flag them."""
    with open(os.path.join(REPO, PKG, "serve", "daemon.py")) as f:
        src = f.read()
    start = src.index("def _update_fields(ureq: dict")
    end = src.index("\nclass ", start)
    assert 'ureq.get("variant")' in src[start:end]
    mutated = src[:start] + re.sub(r"\bureq\b", "payload",
                                   src[start:end]) + src[end:]
    files = {f"{PKG}/serve/daemon.py": mutated}
    for rel in ("config.py", "serve/protocol.py"):
        with open(os.path.join(REPO, PKG, rel)) as f:
            files[f"{PKG}/{rel}"] = f.read()
    rep = run_analysis(_tree(tmp_path, files),
                       checker_ids=["config-doc-drift"])
    assert sorted((f.context, f.message.split(" is ")[0])
                  for f in rep.findings) == [
        ("_update_fields", "payload key 'epochs'"),
        ("_update_fields", "payload key 'variant'")]


# ---------------------------------------------------------------------------
# epoch-stamp
# ---------------------------------------------------------------------------

_ROUTER = {"{pkg}/serve/router.py": '''\
class Router:
    def go(self, base):
        self._send({"op": "submit", "job": 1})
        self._send({"op": "cancel", "router_epoch": 3})
        self._send(dict(op="drain", router_epoch=self.router_epoch))
        self._send(dict(base, op="shutdown"))
        self._send({"op": "status"})
        self._send({"op": "submit", "router_epoch": 0})
'''}


def test_epoch_stamp_enforced(tmp_path):
    rep = _port(tmp_path, _ROUTER, "epoch-stamp")
    got = [(f.line, f.context, f.message.split(" — ")[0])
           for f in rep.findings]
    assert sorted(got) == [
        (3, "Router.go", "mutating payload literal (op='submit') without "
                         "a router_epoch stamp"),
        (4, "Router.go", "op='cancel' stamps a constant router_epoch 3"),
        (6, "Router.go", "mutating payload literal (op='shutdown') "
                         "without a router_epoch stamp")], got
    clean = {"{pkg}/serve/router.py": (
        "class Router:\n    def go(self):\n"
        "        self._send({'op': 'submit', "
        "'router_epoch': self.router_epoch})\n"
        "        self._send({'op': 'query'})\n")}
    assert _port(tmp_path / "ok", clean, "epoch-stamp").clean


# ---------------------------------------------------------------------------
# the port against the reference: mirrored fixtures
# ---------------------------------------------------------------------------

_WAIVED = _LOCKED_CLASS.replace(
    "        self._items.append(2)",
    "        # analyze: allow[lock-discipline] single-threaded teardown\n"
    "        self._items.append(2)")
_BARE = _LOCKED_CLASS.replace(
    "        self._items.append(2)",
    "        # analyze: allow[lock-discipline]\n        self._items.append(2)")

MIRRORED = {
    "lock-mutation": ("lock-discipline", {"{pkg}/box.py": _LOCKED_CLASS}),
    "lock-waiver": ("lock-discipline", {"{pkg}/box.py": _WAIVED}),
    "lock-bare-waiver": ("lock-discipline", {"{pkg}/box.py": _BARE}),
    "check-then-act": ("lock-discipline", {"{pkg}/t.py": _CHECK_THEN_ACT}),
    "check-and-act": ("lock-discipline", {"{pkg}/t.py": _CHECK_AND_ACT}),
    "lock-order-cycle": ("lock-discipline", {"{pkg}/t.py": _TWO_LOCKS}),
    "holds": ("lock-discipline", {"{pkg}/q.py": _HOLDS}),
    "condition-alias": ("lock-discipline", {"{pkg}/r.py": _CONDITION}),
    "purity-closure": ("purity", _PURITY),
    "purity-clean": ("purity", dict(
        _PURITY, **{"{pkg}/serve/helper.py": "import os\n"})),
    "purity-direct": ("purity", {
        "{pkg}/__init__.py": "",
        "{pkg}/serve/__init__.py": "import {mod}\n",
        "{pkg}/serve/x.py": "",
        "{pkg}/serve/protocol.py": "from {pkg}.serve import x\n",
        "{pkg}/serve/router.py": "def f():\n    import {mod}.numpy\n"}),
    "seams": ("fault-seams", _SEAMS),
    "seams-clean": ("fault-seams", _SEAMS_CLEAN),
    "events": ("metrics-schema", _EVENTS),
    "flags": ("config-doc-drift", _FLAGS),
    "envelopes": ("config-doc-drift", _ENVELOPES),
    "epoch-stamp": ("epoch-stamp", _ROUTER),
}


def _mapped(report):
    """(checker, severity, path, line, context, message) of every
    finding, waived ones apart, with the port's names mapped onto the
    reference's."""
    def m(s):
        return (s.replace(PKG, "g2vec_tpu").replace("torch-", "jax-")
                .replace("torch", "jax"))

    return (sorted((m(f.checker), f.severity, m(f.path), f.line, f.context,
                    m(f.message)) for f in report.findings),
            sorted((m(f.checker), f.line, f.context) for f in report.waived))


@pytest.mark.parametrize("case", sorted(MIRRORED))
def test_mirrored_fixture_reports_what_the_reference_reports(tmp_path,
                                                             case):
    checker, files = MIRRORED[case]
    ref_files = {rel.format(pkg="g2vec_tpu", t=""):
                 src.replace("{pkg}", "g2vec_tpu").replace("{mod}", "jax")
                 for rel, src in files.items()}
    ref = ref_run_analysis(
        _tree(tmp_path / "ref", ref_files),
        checker_ids=["jax-purity" if checker == "purity" else checker])
    port = _port(tmp_path / "port", files,
                 "torch-purity" if checker == "purity" else checker)
    assert _mapped(port) == _mapped(ref)
    assert port.clean == ref.clean
    if not case.endswith(("clean", "waiver", "alias", "and-act")):
        assert port.findings, case


# ---------------------------------------------------------------------------
# the repo itself
# ---------------------------------------------------------------------------

def test_repo_is_clean():
    """The CI gate: the full suite over the port, with the committed
    baseline, has zero active findings and zero stale entries — and
    finishes far inside the 30s budget. The baseline is empty."""
    base = os.path.join(REPO, PKG, "analyze", "baseline.json")
    assert load_baseline(base) == {}
    t0 = time.perf_counter()
    rep = run_analysis(REPO, baseline_path=base)
    elapsed = time.perf_counter() - t0
    assert rep.checkers_run == ALL_IDS
    assert not rep.findings, \
        "\n".join(f"{f.location()}: [{f.checker}] {f.message}"
                  for f in rep.findings)
    assert not rep.stale_baseline and not rep.baselined
    assert elapsed < 30.0


def test_seeded_idem_race_is_caught(tmp_path):
    """Strip the ``with self._idem_lock:`` around admit()'s dedup lookup
    in a COPY of the port's daemon.py and prove the lock-discipline
    checker finds the unlocked mutation."""
    with open(os.path.join(REPO, PKG, "serve", "daemon.py")) as f:
        src = f.read()
    pat = re.compile(
        r"^(\s*)with self\._idem_lock:\n"
        r"(\1    orig = self\._idem\.get\(job\.idem_key\)\n"
        r"\1    if orig is None:\n"
        r"\1        self\._idem\[job\.idem_key\] = job\.job_id\n"
        r"\1        reserved = True\n)", re.M)
    m = pat.search(src)
    assert m, "admit()'s idem critical section moved — update this test"
    dedented = "".join(line[4:] if line.strip() else line
                       for line in m.group(2).splitlines(keepends=True))
    mutated = src[:m.start()] + dedented + src[m.end():]
    root = _tree(tmp_path, {f"{PKG}/serve/daemon.py": mutated})
    rep = run_analysis(root, checker_ids=["lock-discipline"])
    hits = [f for f in rep.findings
            if "_idem" in f.message and f.context == "ServeDaemon.admit"]
    assert hits, [f.message for f in rep.findings]
    # The unmutated daemon is clean under the same checker.
    clean = run_analysis(_tree(tmp_path / "ok",
                               {f"{PKG}/serve/daemon.py": src}),
                         checker_ids=["lock-discipline"])
    assert clean.clean


def test_shard_ring_accounting_is_guarded(tmp_path):
    """``ShardRing``'s five accounting fields carry ``# guarded-by:
    _cv``: a write to any of them outside the condition is found."""
    with open(os.path.join(REPO, PKG, "train", "stream.py")) as f:
        src = f.read()
    fields = ("occupancy_hw", "peak_bytes", "shards_put", "wait_put_s",
              "wait_get_s")
    for name in fields:
        assert re.search(rf"self\.{name} = \S+ +# guarded-by: _cv\b", src)
    anchor = "    def put(self, shard: Shard) -> bool:\n"
    assert anchor in src
    poke = "".join(f"        self.{name} = 0\n" for name in fields)
    mutated = src.replace(anchor,
                          "    def _poke(self):\n" + poke + "\n" + anchor)
    root = _tree(tmp_path, {f"{PKG}/train/stream.py": mutated})
    rep = run_analysis(root, checker_ids=["lock-discipline"])
    assert sorted(f.message.split(" is ")[0] for f in rep.findings) == \
        sorted(f"ShardRing.{name}" for name in fields)
    assert {f.context for f in rep.findings} == {"ShardRing._poke"}


def test_unknown_checker_id_raises():
    with pytest.raises(KeyError):
        run_analysis(REPO, checker_ids=["no-such-checker"])


# ---------------------------------------------------------------------------
# regression tests for the races the checker guards (on the port's daemon)
# ---------------------------------------------------------------------------

def _daemon(tmp_path):
    from g2vec_tpu_torch.serve.daemon import ServeDaemon, ServeOptions
    opts = ServeOptions(
        socket_path=os.path.join(str(tmp_path), "serve.sock"),
        state_dir=os.path.join(str(tmp_path), "state"), device="cpu")
    return ServeDaemon(opts, console=lambda s: None)


def _hammer(n_threads, fn):
    errs = []

    def run():
        try:
            fn()
        except BaseException as e:      # pragma: no cover - diagnostic
            errs.append(e)

    ts = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs


def test_job_id_serial_has_no_lost_updates(tmp_path):
    """``_serial += 1`` runs on connection threads: two unlocked admits
    could read the same value and mint colliding serials. After N
    increments from T threads the counter must be exactly N*T."""
    d = _daemon(tmp_path)
    ids = []

    def mint():
        for _ in range(200):
            ids.append(d._new_job_id())

    _hammer(8, mint)
    assert d._serial == 8 * 200
    serials = [i.split("-")[0] for i in ids]
    assert len(set(serials)) == len(serials)


def test_state_counts_have_no_lost_updates(tmp_path):
    """``_state_counts[state] += 1`` runs on the scheduler thread AND
    connection threads; unlocked, concurrent bumps vanish."""
    d = _daemon(tmp_path)

    def bump():
        for _ in range(300):
            d._job_state("jX", "queued")

    _hammer(6, bump)
    assert d._state_counts["queued"] == 6 * 300
    assert d.status()["job_states"]["queued"] == 6 * 300


# ---------------------------------------------------------------------------
# python -m g2vec_tpu_torch analyze: the exit-code contract
# ---------------------------------------------------------------------------

def _run_analyze(*args, timeout=120, script=None):
    cmd = ([sys.executable, script] if script
           else [sys.executable, "-m", PKG, "analyze"])
    return subprocess.run(
        [*cmd, *args], capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)


def test_analyze_clean_repo_exits_zero(tmp_path):
    res = _run_analyze("--json")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    report = json.loads(res.stdout)
    assert report["clean"] is True
    assert report["checkers"] == ALL_IDS
    assert report["counts"]["active"] == 0
    assert report["counts"]["baselined"] == 0
    assert report["counts"]["stale_baseline"] == 0
    assert report["elapsed_s"] < 30.0
    # The reference's report keys, no more and no fewer.
    ref = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu", "analyze", "--json", "--root",
         str(tmp_path)], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO,
                              JAX_PLATFORMS="cpu"), cwd=REPO)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert sorted(report) == sorted(json.loads(ref.stdout))
    text = _run_analyze()
    assert text.returncode == 0
    last = text.stdout.splitlines()[-1]
    assert last.startswith("[analyze] clean: 0 finding(s), ")
    assert "0 baselined, 0 stale (lock-discipline, torch-purity, " \
        "fault-seams, metrics-schema, config-doc-drift, epoch-stamp; " in last


def test_analyze_findings_exit_one(tmp_path):
    bad = tmp_path / PKG / "bad.py"
    bad.parent.mkdir()
    bad.write_text(
        "import threading\n\n"
        "class B:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._xs = []       # guarded-by: _lock\n\n"
        "    def poke(self):\n"
        "        self._xs.append(1)\n")
    res = _run_analyze("--json", "--root", str(tmp_path))
    assert res.returncode == 1, res.stdout[-2000:] + res.stderr[-2000:]
    report = json.loads(res.stdout)
    assert report["clean"] is False
    assert report["counts"]["active"] == 1
    f = report["findings"][0]
    assert f["checker"] == "lock-discipline" and f["path"] == f"{PKG}/bad.py"
    # The script form, on the same tree: the same verdict.
    res2 = _run_analyze("--root", str(tmp_path),
                        script=os.path.join(REPO, PKG, "tools",
                                            "run_analyze.py"))
    assert res2.returncode == 1
    assert f"{PKG}/bad.py:9: [lock-discipline] error:" in res2.stdout
    assert "[analyze] FAIL: 1 finding(s)" in res2.stdout


def test_analyze_usage_errors_exit_two():
    res = _run_analyze("--checker", "bogus")
    assert res.returncode == 2
    assert "bogus" in res.stderr
    res2 = _run_analyze("--not-a-flag")
    assert res2.returncode == 2
    res3 = _run_analyze("--list-checkers")
    assert res3.returncode == 0
    assert [line.split()[0] for line in res3.stdout.splitlines()] == ALL_IDS


def test_write_baseline_then_stale_through_the_cli(tmp_path):
    root = _tree(tmp_path, {f"{PKG}/box.py": _LOCKED_CLASS})
    res = _run_analyze("--root", root, "--write-baseline")
    assert res.returncode == 0 and "wrote 1 suppression(s)" in res.stdout
    base = tmp_path / PKG / "analyze" / "baseline.json"
    assert len(json.loads(base.read_text())["suppressions"]) == 1
    assert _run_analyze("--root", root).returncode == 0
    (tmp_path / PKG / "box.py").write_text(
        _LOCKED_CLASS.replace("        self._items.append(2)",
                              "        pass"))
    res2 = _run_analyze("--root", root)
    assert res2.returncode == 1 and "stale suppression" in res2.stdout


_IN_PROCESS = r"""
import io, json, sys, contextlib
from g2vec_tpu_torch.__main__ import main
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = main(["analyze", "--json"])
report = json.loads(buf.getvalue())
print(json.dumps({"rc": rc, "clean": report["clean"],
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in
                                   ("torch", "triton", "jax", "g2vec_tpu",
                                    "numpy"))}))
"""


def test_analyze_in_process_imports_no_torch():
    """``analyze`` is dispatched before any config parse: an in-process
    run through the CLI's ``main`` loads no torch (nor numpy, jax or the
    JAX package)."""
    res = subprocess.run([sys.executable, "-c", _IN_PROCESS],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "clean": True, "loaded": []}
