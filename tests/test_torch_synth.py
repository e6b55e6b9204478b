"""The port's scale-free synthetic graph against ``g2vec_tpu.data.synth``.

- ``write_synth_graph`` writes the reference's files byte for byte for
  the same spec (exact), over specs that move every field.
- The edge stream is chunk-independent and equals the reference's edges.
- ``python -m g2vec_tpu_torch.tools.make_synth_graph`` writes the same
  files as the library call and prints their summary, importing no jax.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from g2vec_tpu.data import synth as jsynth
from g2vec_tpu_torch.data import synth

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("expression", "clinical", "network")

SPECS = [
    dict(n_genes=300, n_good=6, n_poor=5, seed=0),
    dict(n_genes=2_000, n_good=8, n_poor=8, attach=2, seed=5),
    dict(n_genes=777, n_good=4, n_poor=9, attach=4, active_prob=0.4,
         noise=0.6, shift=2.0, seed=13),
]


def _read(paths):
    out = {}
    for key in FILES:
        with open(paths[key], "rb") as f:
            out[key] = f.read()
    return out


@pytest.mark.parametrize("fields", SPECS, ids=lambda f: f"G{f['n_genes']}")
def test_write_synth_graph_is_the_reference_bytes(fields, tmp_path):
    got = synth.write_synth_graph(synth.SynthGraphSpec(**fields),
                                  str(tmp_path / "port"))
    want = jsynth.write_synth_graph(jsynth.SynthGraphSpec(**fields),
                                    str(tmp_path / "jax"))
    assert _read(got) == _read(want)
    assert (got["n_genes"], got["n_edges"]) == (want["n_genes"],
                                                 want["n_edges"])


@pytest.mark.parametrize("chunk", [5, 37, 1 << 20])
def test_edge_stream_is_chunk_independent_and_the_reference_edges(chunk):
    s1, d1 = synth.make_scale_free_edges(500, 3, np.random.default_rng(5))
    js, jd = jsynth.make_scale_free_edges(500, 3, np.random.default_rng(5))
    np.testing.assert_array_equal(s1, js)
    np.testing.assert_array_equal(d1, jd)
    chunks = list(synth.iter_scale_free_edges(500, 3,
                                              np.random.default_rng(5),
                                              chunk_edges=chunk))
    assert all(len(c[0]) <= chunk for c in chunks)
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks]), s1)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]), d1)


def test_make_synth_graph_arrays_and_validation():
    spec = synth.SynthGraphSpec(n_genes=200, n_good=3, n_poor=4, seed=1)
    genes, samples, labels, expr, (src, dst) = synth.make_synth_graph(spec)
    jgenes, jsamples, jlabels, jexpr, (jsrc, jdst) = jsynth.make_synth_graph(
        jsynth.SynthGraphSpec(n_genes=200, n_good=3, n_poor=4, seed=1))
    assert list(genes) == list(jgenes) and list(samples) == list(jsamples)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(expr, jexpr)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    assert expr.shape == (7, 200) and spec.n_samples == 7
    with pytest.raises(ValueError, match="attach"):
        synth.make_scale_free_edges(4, 3, np.random.default_rng(0))


def test_make_synth_graph_tool_writes_the_library_files(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, runpy, sys\n"
         "sys.argv = ['make_synth_graph', *sys.argv[1:]]\n"
         "try:\n"
         "    runpy.run_module('g2vec_tpu_torch.tools.make_synth_graph',"
         " run_name='__main__')\n"
         "except SystemExit as e:\n"
         "    assert not e.code, e.code\n"
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'g2vec_tpu'))\n"
         "print(json.dumps(bad))\n",
         "--genes", "400", "--good", "5", "--poor", "6", "--seed", "3",
         "--out", str(tmp_path / "cli"), "--prefix", "s"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    *summary, bad = proc.stdout.strip().splitlines()
    assert json.loads(bad) == []
    summary = json.loads("\n".join(summary))
    assert summary["n_genes"] == "400"
    want = synth.write_synth_graph(
        synth.SynthGraphSpec(n_genes=400, n_good=5, n_poor=6, seed=3),
        str(tmp_path / "lib"), prefix="s")
    assert _read(summary) == _read(want)
    with open(summary["expression"]) as f:
        assert sum(1 for _ in f) == 401
