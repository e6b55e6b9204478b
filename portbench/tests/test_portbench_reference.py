"""The plain reference against the port's ``--device cpu`` path at a small
size: a sound run is judged correct, and the control and each fault the
cells can have are judged not correct.

The control is the reference put in the program's place a precision
lower than the configuration states (``Precision.control``). The faults
(``faults.py``) are planted in the port underneath a run of the harness:
a training step that leaves the state unchanged, a loss over half of the
batch, an L-group altered where it is produced, and k-means without its
Lloyd steps. (k-means keeping its worst restart or drawn from another
seed reads inside the band of sound runs on the cells' embeddings, so no
limit holds them: PERF.md.) A run across chips has no exchange
to leave out: every cell takes one chip.
"""
import json

import numpy as np
import pytest

from pbtest import cuda, small_cell  # noqa: F401 (a fixture)

pytestmark = pytest.mark.torch

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "checks"}


def _run(workload="example.solo", seed=2 ** 31 + 77, seconds=1.0,
         trace=False):
    import harness

    return harness.run_cell(small_cell(workload), seed, seconds, trace,
                            device="cpu", log=lambda s: None)


def test_walker_is_the_ports_cpp_walker_bitwise():
    import gen
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr, walk_packed_rows
    from reference import plain

    from pbtest import SMALL

    ds = gen.make_dataset(SMALL, 5)
    g = plain.common_graph(ds.names, ds.samples, ds.labels, ds.expr_rows,
                           ds.expr_values(), ds.src, ds.dst)
    for grp in (0, 1):
        s, d, w = thresholded_edges(
            g.expr[g.labels == grp].astype(np.float32),
            g.src.astype(np.int32), g.dst.astype(np.int32), device="cpu")
        indptr, indices, weights = edges_to_csr(s, d, w, g.genes.size)
        port = walk_packed_rows(s, d, w, g.genes.size, len_path=80, reps=10,
                                seed=(9 << 1) | grp)
        ref = plain.walk_rows((indptr.astype(np.int64),
                               indices.astype(np.int64), weights),
                              g.genes.size, 80, 10, (9 << 1) | grp)
        assert np.array_equal(port, ref)
        _, ref_idx, _ = plain.group_csr(g, grp, 0.5)
        assert ref_idx.size == indices.size


@pytest.mark.parametrize("workload,trace", [
    ("example.solo", False), ("example.solo", True),
    ("lihc.solo-native", False), ("example.seeds8", False)])
def test_sound_run_is_correct_and_the_line_keeps_its_schema(workload,
                                                            trace):
    out = _run(workload, trace=trace)
    assert out["correct"], out["checks"]
    assert set(out) - {"breakdown"} == LINE_KEYS
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert json.loads(json.dumps(out)) == out
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "load_s.solo" in out["metrics"]
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        e2e = "runs_per_hour" if workload == "example.seeds8" else "run_s"
        assert set(out["metrics"]) == {"setup_s", e2e}
        assert out["metrics"][e2e]["value"] > 0


def test_the_control_is_not_correct():
    """Every number the control reads against a sound run's."""
    import gen
    from reference import judge, plain

    ns = small_cell("example.solo")
    run = ns.config["run"]
    sound, control = [], []
    for seed in (11, 12, 13):
        ds = gen.make_dataset(ns.config["data"], seed)
        g = plain.common_graph(ds.names, ds.samples, ds.labels,
                               ds.expr_rows, ds.expr_values(), ds.src,
                               ds.dst)
        ref3 = plain.stage3(g, run, seed)
        for prec, sink in ((plain.PLAIN, sound),
                           (plain.Precision.control(), control)):
            out = plain.run_reference(g, run, seed, seed, seed, "cpu", prec)
            sink.append(judge.judge_run(out, g, run, seed, seed, "cpu",
                                        ref3))
    for r in sound:
        assert judge.verdict(r["numbers"], ns.limits), r
    for r in control:
        assert not judge.verdict(r["numbers"], ns.limits), r
    for k in ("rows", "loss", "flips", "score"):
        assert min(r["numbers"][k] for r in control) > ns.limits[k]


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_lgroup", "kmeans_no_lloyd"])
def test_a_fault_underneath_a_run_is_not_correct(fault, monkeypatch):
    import faults

    faults.FAULTS[fault](monkeypatch)
    out = _run()
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ["example.solo", "lihc.solo-device"])
def test_control_at_the_cells_size_on_the_card(workload, cuda):
    """On the card: the control reads above every limit it is held to."""
    import calibrate
    import harness

    lines = []
    calibrate.readings(harness.resolve(workload), [], [5],
                       emit=lines.append)
    r = json.loads(lines[0])
    assert r["control"] and not all(
        r["numbers"][k] <= v for k, v in harness.resolve(
            workload).limits.items())
