"""BENCHMARK.json and the files it names: each configuration, traffic
mix, entry, limit set and metric reader is found by its name, and every
entry keeps the benchmark's schema."""
import dataclasses
import importlib.util
import json
import os
import re
from types import SimpleNamespace

import pytest

from pbtest import BENCH, ROOT

pytestmark = pytest.mark.torch

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_entry_keys():
    b = _bench()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for entry in b["configs"] + b["workloads"] + b["end_to_end"] \
            + b["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in names
        names.add(entry["name"])
    assert {m["name"] for m in b["end_to_end"]} == {"run_s",
                                                    "runs_per_hour",
                                                    "setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits",
                                  "metrics", "end_to_end"])
def test_each_named_file_exists(kind):
    b = _bench()
    cells = {w["name"]: w for w in b["workloads"]}
    if kind == "configs":
        for c in b["configs"]:
            path = os.path.join(ROOT, c["file"])
            with open(path) as f:
                cfg = json.load(f)
            assert c["file"] == f"portbench/configs/{c['name']}.json"
            assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    elif kind == "traffic":
        for w in cells.values():
            with open(os.path.join(BENCH, "traffic",
                                   w["traffic"] + ".json")) as f:
                mix = json.load(f)
            assert set(mix) <= {"entry", "seed_stride", "flags"}
            entry = os.path.join(BENCH, "entries", mix["entry"] + ".py")
            assert os.path.exists(entry), entry
            from g2vec_tpu_torch.config import G2VecConfig

            fields = {f.name for f in dataclasses.fields(G2VecConfig)}
            assert set(mix.get("flags", {})) <= fields
    elif kind == "limits":
        from reference.judge import NUMBERS

        for name in cells:
            with open(os.path.join(BENCH, "limits", name + ".json")) as f:
                assert set(json.load(f)) == set(NUMBERS)
    elif kind == "end_to_end":
        for m in b["end_to_end"]:
            assert os.path.exists(os.path.join(BENCH, "end_to_end",
                                               m["name"] + ".py"))
    else:
        for m in b["per_layer"]:
            assert set(m["workloads"]) <= set(cells)
            assert m["moves"] in {e["name"] for e in b["end_to_end"]}
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               m["name"] + ".py"))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = _bench()
    for w in b["workloads"]:
        e2e = [m for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
        for m in b["per_layer"]:
            if w["name"] in m["workloads"]:
                moved = [e for e in e2e if e["name"] == m["moves"]]
                assert moved, (w["name"], m["name"])


@pytest.mark.parametrize("name", sorted(
    n[:-3] for n in os.listdir(os.path.join(BENCH, "metrics"))
    if n.endswith(".py")))
def test_reader_returns_nothing_when_there_is_nothing_to_read(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for kind in ("solo", "batch"):
        ctx = SimpleNamespace(kind=kind, walker="auto", jobs=[], traced=[],
                              trace={"kernels": {}, "busy_s": 0.0,
                                     "window_s": 0.0}, walk_bound_s=0.0)
        assert mod.read(ctx) is None


@pytest.mark.parametrize("name", sorted(
    n[:-3] for n in os.listdir(os.path.join(BENCH, "end_to_end"))
    if n.endswith(".py")))
def test_end_to_end_reader_reads_the_window(name):
    spec = importlib.util.spec_from_file_location(
        "e_" + name, os.path.join(BENCH, "end_to_end", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jobs = [SimpleNamespace(units=[1] * 8), SimpleNamespace(units=[1] * 8)]
    full = SimpleNamespace(records=jobs, window_s=40.0, setup_s=12.5)
    empty = SimpleNamespace(records=[], window_s=40.0, setup_s=12.5)
    want = {"setup_s": (12.5, 12.5), "run_s": (20.0, None),
            "runs_per_hour": (1440.0, None)}[name]
    assert (mod.read(full), mod.read(empty)) == want
