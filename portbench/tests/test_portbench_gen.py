"""The generator: the same bytes for a seed, and each configuration's
published counts, as the port reads the files."""
import hashlib
import json
import os

import numpy as np
import pytest

from pbtest import BENCH

pytestmark = pytest.mark.torch


def _spec(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _counts(ds):
    """The published counts a dataset has, computed from its arrays."""
    expr = set(ds.expr_rows.tolist())
    net = set(ds.src.tolist()) | set(ds.dst.tolist())
    common = expr & net
    both = np.isin(ds.src, list(common)) & np.isin(ds.dst, list(common))
    return {"samples": len(ds.samples), "good": int((ds.labels == 0).sum()),
            "poor": int((ds.labels == 1).sum()), "common_genes": len(common),
            "common_edges": int(both.sum()), "network_genes": len(net),
            "network_edges": int(ds.src.size),
            "expression_genes": len(expr)}


def _digest(paths):
    h = hashlib.sha256()
    for k in sorted(paths):
        with open(paths[k], "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    import gen

    spec = _spec("g2vec-example")["data"]
    a = _digest(gen.write_tsvs(gen.make_dataset(spec, 2 ** 31 + 9),
                               str(tmp_path / "a")))
    b = _digest(gen.write_tsvs(gen.make_dataset(spec, 2 ** 31 + 9),
                               str(tmp_path / "b")))
    c = _digest(gen.write_tsvs(gen.make_dataset(spec, 2 ** 31 + 10),
                               str(tmp_path / "c")))
    assert a == b != c


@pytest.mark.parametrize("name", ["g2vec-example", "lihc-string"])
def test_published_counts(name):
    import gen

    cfg = _spec(name)
    got = _counts(gen.make_dataset(cfg["data"], 3))
    d = cfg["data"]
    want = {"samples": d["n_good"] + d["n_poor"], "good": d["n_good"],
            "poor": d["n_poor"], "common_genes": d["common_genes"],
            "common_edges": d["common_edges"],
            "network_genes": d["network_genes"],
            "network_edges": d["network_edges"],
            "expression_genes": d["common_genes"]
            + d["expression_only_genes"]}
    assert got == want
    pub = cfg["published"]
    assert {k: got[k] for k in pub if k in got} == {
        k: v for k, v in pub.items() if k in got}


def test_example_counts_are_the_transcripts():
    cfg = _spec("g2vec-example")
    assert cfg["published"] == {**cfg["published"], "samples": 135,
                                "good": 77, "poor": 58,
                                "common_genes": 7523,
                                "common_edges": 216540,
                                "network_genes": 9899,
                                "network_edges": 298799}


def test_the_port_reads_what_was_written(tmp_path):
    import gen
    from g2vec_tpu_torch.io.readers import (load_clinical, load_expression,
                                            load_network)
    from g2vec_tpu_torch.pipeline import preprocess_inputs

    spec = _spec("g2vec-example")["data"]
    ds = gen.make_dataset(spec, 4)
    paths = gen.write_tsvs(ds, str(tmp_path))
    data = load_expression(paths["expression"], use_native=False)
    assert data.expr.shape == (135, 7523)
    row = int(np.flatnonzero(ds.names[ds.expr_rows] == data.gene[0])[0])
    assert np.array_equal(data.expr[:, 0],
                          (ds.expr_micro[row] / 1e6).astype(np.float32))
    data, src, _ = preprocess_inputs(data, load_clinical(paths["clinical"]),
                                     load_network(paths["network"]))
    assert data.expr.shape[1] == 7523 and src.size == 216540
