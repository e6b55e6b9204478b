"""The port's metrics events against the port's declared schema.

``g2vec_tpu_torch/utils/metrics_schema.py`` (the port's copy of the JAX
package's table, held equal to it by ``tests/test_torch_analyze.py``)
pins, per event kind, the fields an emission must carry and the ones it
may carry; the port's ``metrics-schema`` checker lints every literal emit
site with it. This test applies the same rules to every literal
``.emit("<kind>", ...)`` in ``g2vec_tpu_torch/`` (the router and the
chaos soak included) on its own: the schema is read with
``ast.literal_eval``, as the checker reads it, and a splat (``**fields``)
waives the missing-field check but not the unknown-field one. A site
whose kind is not a string literal is a relay shim and is checked where
the event is first emitted.
"""
import ast
import os

import pytest

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA_FILE = os.path.join(ROOT, "g2vec_tpu_torch", "utils",
                           "metrics_schema.py")


def _schemas():
    with open(SCHEMA_FILE) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "EVENT_SCHEMAS"
                for t in node.targets):
            raw = ast.literal_eval(node.value)
            return {kind: (set(s.get("required", ())),
                           set(s.get("optional", ())))
                    for kind, s in raw.items()}
    raise AssertionError("EVENT_SCHEMAS not found")


def _emit_sites():
    out = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "g2vec_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "emit" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    out.append((os.path.relpath(path, ROOT), node))
    return out


def _problems(kind, node, schemas):
    if kind not in schemas:
        return [f"emit({kind!r}) is not a declared event kind"]
    required, optional = schemas[kind]
    present = {kw.arg for kw in node.keywords if kw.arg is not None}
    splat = any(kw.arg is None for kw in node.keywords)
    out = [f"emit({kind!r}) passes undeclared field {f!r}"
           for f in sorted(present - required - optional)]
    if not splat:
        out += [f"emit({kind!r}) is missing required field {f!r}"
                for f in sorted(required - present)]
    return out


def test_every_port_emit_matches_the_schema():
    schemas = _schemas()
    sites = _emit_sites()
    # The router, the fleet and the soak's own files are among the sites.
    files = {path for path, _ in sites}
    assert "g2vec_tpu_torch/serve/router.py" in files
    assert "g2vec_tpu_torch/serve/daemon.py" in files
    assert "g2vec_tpu_torch/resilience/fleet.py" in files
    assert len(sites) > 100
    bad = [f"{path}:{node.lineno}: {msg}" for path, node in sites
           for msg in _problems(node.args[0].value, node, schemas)]
    assert not bad, "\n".join(bad)


def test_the_lint_finds_what_the_jax_checker_finds():
    """The rules above are the checkers': on the same call sites both
    report an unknown kind, an undeclared field and a missing required
    field, and a splat waives only the last."""
    schemas = _schemas()
    calls = {
        'm.emit("no_such_kind", a=1)': ["not a declared event kind"],
        'm.emit("job_rejected", error="x", op="update")':
            ["undeclared field 'op'"],
        'm.emit("job_rejected", detail="x")':
            ["missing required field 'error'"],
        'm.emit("job_rejected", **extra)': [],
        'm.emit("job_rejected", error="x", detail="op \'update\'")': [],
    }
    for src, want in calls.items():
        node = ast.parse(src).body[0].value
        got = _problems(node.args[0].value, node, schemas)
        assert len(got) == len(want), (src, got)
        for g, w in zip(got, want):
            assert w in g, (src, got)


@pytest.mark.parametrize("kind", ["heartbeat", "straggler_warning",
                                  "fleet_launch", "fleet_peer_death",
                                  "fleet_replan", "fleet_done", "gave_up"])
def test_the_fleet_emits_each_event_within_the_schema(kind):
    """The fleet's events (``utils/metrics_schema.py``:
    ``heartbeat``, ``straggler_warning``, ``fleet_*``) are emitted by the
    port's fleet module, each site within its declared fields."""
    schemas = _schemas()
    sites = [node for path, node in _emit_sites()
             if path == "g2vec_tpu_torch/resilience/fleet.py"
             and node.args[0].value == kind]
    assert sites, f"the port's fleet never emits {kind!r}"
    for node in sites:
        assert not _problems(kind, node, schemas)
