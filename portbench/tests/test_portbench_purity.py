"""Nothing the benchmark runs imports the JAX stack or the JAX package
(top-level names compared whole: ``g2vec_tpu_torch`` is not
``g2vec_tpu``), the reference imports nothing of the port, and without a
card the command prints no result and exits non-zero."""
import ast
import json
import os
import subprocess
import sys

import pytest

from pbtest import BENCH, ROOT

pytestmark = pytest.mark.torch

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "g2vec_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_the_jax_stack_or_package():
    bad = {(p, m) for p in _sources(BENCH) for m in _imports(p)
           if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    bad = {(p, m) for p in _sources(os.path.join(BENCH, "reference"))
           for m in _imports(p) if m.startswith("g2vec_tpu")}
    assert not bad


def test_a_whole_run_leaves_no_jax_module_loaded():
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "from pbtest import small_cell\n"
            "import harness\n"
            "out = harness.run_cell(small_cell('example.solo'), 3, 0.5, "
            "False, device='cpu', log=lambda s: None)\n"
            "mods = sorted({m.split('.')[0] for m in sys.modules})\n"
            "print(json.dumps([out['correct'], mods]))"
            % (os.path.join(BENCH, "tests"), BENCH))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and "g2vec_tpu_torch" in mods
    assert not FORBIDDEN & set(mods)


def test_without_a_card_no_result_and_a_nonzero_exit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "example.solo",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
