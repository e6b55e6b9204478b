"""Stage overlap, the stage timer and ``--metrics-jsonl`` in the port.

- The scheduler's drain contract (``parallel/overlap.py``): a task's
  first exception propagates at its join and at ``drain``, dependents of
  a failed task are cancelled and never run, and ``close`` wakes a
  blocked task through its closer, so nothing deadlocks.
- The pipeline's three output files are byte-identical with overlap and
  without it, in both train modes.
- The metrics stream: ``g2vec_tpu.pipeline.run`` and the port's run of the
  same small spec emit the same event names in the same order (epochs
  folded), each port event carries a subset of the reference event's
  fields (the config's ``device`` aside), and the ``done`` record holds the run's stage seconds.
"""
import json
import threading
import time

import pytest

from g2vec_tpu.config import G2VecConfig as JaxConfig
from g2vec_tpu_torch.config import G2VecConfig, config_from_args
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.parallel.overlap import OverlapScheduler, TaskCancelled
from g2vec_tpu_torch.pipeline import run
from g2vec_tpu_torch.utils.metrics import MetricsWriter
from g2vec_tpu_torch.utils.timing import StageTimer, span

pytestmark = pytest.mark.torch

SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
ARGS = dict(lenPath=20, numRepetition=3, sizeHiddenlayer=16, epoch=8,
            numBiomarker=10, seed=11, compute_dtype="float32",
            shard_paths=24, kmeans_iters=50)


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

def test_results_and_dependencies_run_in_order():
    order = []
    with OverlapScheduler(max_workers=3) as ov:
        ov.submit("a", lambda: order.append("a") or 1)
        ov.submit("b", lambda: order.append("b") or 2, deps=["a"])
        assert ov.result("b") == 2 and ov.result("a") == 1
        assert ov.has("a") and not ov.has("c")
        ov.drain()
        assert order == ["a", "b"]
        assert set(ov.saved_seconds()) == {"a", "b"}
    ov = OverlapScheduler()
    try:
        ov.submit("x", lambda: 0)
        with pytest.raises(ValueError, match="duplicate"):
            ov.submit("x", lambda: 0)
        with pytest.raises(ValueError, match="unsubmitted"):
            ov.submit("y", lambda: 0, deps=["nope"])
    finally:
        ov.close()


def test_first_failure_propagates_and_dependents_are_cancelled():
    ran = []
    with OverlapScheduler(max_workers=4) as ov:
        ov.submit("ok", lambda: ran.append("ok"))

        def bad():
            raise KeyError("kernel library did not build")

        ov.submit("bad", bad)
        ov.submit("child", lambda: ran.append("child"), deps=["bad"])
        ov.submit("late", lambda: (_ for _ in ()).throw(OSError("second")))
        with pytest.raises(KeyError, match="did not build"):
            ov.result("bad")
        with pytest.raises(TaskCancelled, match="dependency 'bad' failed"):
            ov.result("child")
        # drain re-raises the FIRST real failure in submission order, never
        # the cancellation shadow, and never the later failure.
        with pytest.raises(KeyError):
            ov.drain()
    assert ran == ["ok"]


def test_close_wakes_a_blocked_task_through_its_closer():
    release = threading.Event()
    ov = OverlapScheduler(max_workers=2)
    ov.add_closer(release.set)
    ov.submit("blocked", lambda: release.wait(30))
    t0 = time.perf_counter()
    ov.close()
    assert time.perf_counter() - t0 < 10
    assert release.is_set()


def test_removed_closer_does_not_run():
    calls = []
    ov = OverlapScheduler()
    remove = ov.add_closer(lambda: calls.append(1))
    remove()
    remove()
    ov.close()
    assert calls == []


# ---------------------------------------------------------------------------
# Timer and metrics writer
# ---------------------------------------------------------------------------

def test_stage_timer_syncs_before_the_clock_stops():
    synced = []
    timer = StageTimer(sync=lambda: synced.append(len(timer.stages)))
    with timer.stage("a"):
        pass
    with pytest.raises(ZeroDivisionError):
        with timer.stage("b"):
            1 / 0
    timer.annotate("a", parser="native")
    timer.annotate("a", threads=2)
    assert [name for name, _ in timer.stages] == ["a", "b"]
    assert synced == [0]          # a failing stage is not synced
    assert timer.extras_dict() == {"a": {"parser": "native", "threads": 2}}
    assert timer.total == sum(timer.as_dict().values())


def test_spans_nest_and_their_repeats_add_up():
    timer = StageTimer()
    with timer.stage("paths"):
        for _ in range(3):
            with span("walk_g"):
                with span("row_set"):
                    time.sleep(0.001)
        with span("integrate"):
            pass
    with timer.stage("train"):
        with span("walk_g"):
            pass
    extras = timer.extras_dict()
    assert extras["paths"]["span_n"] == {"walk_g": 3, "walk_g/row_set": 3,
                                         "integrate": 1}
    secs = extras["paths"]["span_s"]
    assert set(secs) == set(extras["paths"]["span_n"])
    assert 0.003 <= secs["walk_g/row_set"] <= secs["walk_g"]
    assert extras["train"]["span_n"] == {"walk_g": 1}


def test_a_span_outside_a_stage_records_nothing():
    timer = StageTimer()
    with span("read_network"):
        pass
    with timer.stage("load"):
        pass
    with span("read_network"):
        pass
    assert timer.extras_dict() == {}
    assert [name for name, _ in timer.stages] == ["load"]


def test_a_scheduler_task_records_into_the_submitting_stage():
    timer = StageTimer()
    threads = []

    def parse(name):
        threads.append(threading.current_thread())
        with span(name):
            time.sleep(0.001)

    with OverlapScheduler(max_workers=2) as ov:
        ov.submit("build", lambda: parse("build"))
        ov.result("build")
        with timer.stage("load"):
            ov.submit("read_expression", lambda: parse("read_expression"))
            with span("read_network"):
                pass
            ov.result("read_expression")
    assert threading.current_thread() not in threads
    extras = timer.extras_dict()
    assert extras.keys() == {"load"}
    assert extras["load"]["span_n"] == {"read_expression": 1,
                                        "read_network": 1}


def test_metrics_writer_lines_and_bound_views(tmp_path):
    path = tmp_path / "m.jsonl"
    with MetricsWriter(str(path)) as m:
        m.emit("config", a="1")
        m.bind_job("j1").bind_lane("0:ab").emit("epoch", step=0)
    MetricsWriter(None).emit("ignored")
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["seq"], r["event"]) for r in recs] == [(0, "config"),
                                                      (1, "epoch")]
    assert recs[1]["job_id"] == "j1" and recs[1]["lane"] == "0:ab"


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("overlap")))


def _port(files, out, **over):
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"], result_name=out,
                      device="cpu", **dict(ARGS, **over))
    return run(cfg, console=lambda s: None)


def _bytes(result):
    return [open(p, "rb").read() for p in result.output_files]


@pytest.mark.parametrize("mode", ["full", "streaming"])
def test_outputs_byte_identical_with_and_without_overlap(files, tmp_path,
                                                         mode):
    on = _port(files, str(tmp_path / "on"), train_mode=mode, overlap=True)
    off = _port(files, str(tmp_path / "off"), train_mode=mode, overlap=False)
    assert _bytes(on) == _bytes(off)
    assert off.overlap_saved_s == {}
    expect = {"full": set(), "streaming": {"stream_shards"}}[mode]
    assert set(on.overlap_saved_s) == expect | {"read_expression"}


def test_a_kernel_build_error_raises_where_the_build_is_joined():
    """The kernel library builds on a scheduler thread; its error
    propagates where the foreground joins the build, before the first
    launch, and a run that started no build joins nothing."""
    from g2vec_tpu_torch import pipeline

    def build():
        raise RuntimeError("build failed: nvcc exited 1")

    with OverlapScheduler() as ov:
        pipeline._join_kernel_build(ov)
        ov.submit("build_kernels", build)
        with pytest.raises(RuntimeError, match="nvcc exited 1"):
            pipeline._join_kernel_build(ov)


def _events(path):
    recs = [json.loads(line) for line in open(path)]
    names = []
    for r in recs:
        if not (names and names[-1] == r["event"] == "epoch"):
            names.append(r["event"])
    return names, {r["event"]: r for r in recs}


@pytest.mark.parametrize("mode", ["full", "streaming"])
def test_metrics_jsonl_has_the_reference_events(files, tmp_path, mode):
    from g2vec_tpu.pipeline import run as jax_run

    jax_path = str(tmp_path / "jax.jsonl")
    jax_run(JaxConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp_path / "jax"),
                      walker_backend="native", train_mode=mode,
                      metrics_jsonl=jax_path, **dict(ARGS, epoch=2)),
            console=lambda s: None)
    port_path = str(tmp_path / "port.jsonl")
    result = _port(files, str(tmp_path / "port"), train_mode=mode, epoch=2,
                   metrics_jsonl=port_path)
    got_names, got = _events(port_path)
    want_names, want = _events(jax_path)
    assert got_names == want_names
    for name, rec in got.items():
        # ``device`` is the port's own config field.
        assert set(rec) - {"device"} <= set(want[name]), name
    assert got["done"]["stage_seconds"] == result.stage_seconds
    extras = got["done"]["stage_extras"]
    assert extras["load"]["expression_parser"] == "native"
    assert extras["load"]["network_parser"] == "native"
    reads = {"read_expression", "read_clinical", "read_network"}
    assert extras["load"]["span_n"] == dict.fromkeys(reads, 1)
    assert set(extras["load"]["span_s"]) == reads
    assert set(extras) == {"full": {"load", "paths"},
                           "streaming": {"load"}}[mode]
    assert set(got["config"]) - {"seq", "ts", "event"} == set(
        vars(G2VecConfig()))


def test_cli_flags_reach_the_config():
    cfg = config_from_args(
        ["e", "c", "n", "out", "--train-mode", "streaming", "--shard-paths",
         "64", "--prefetch-depth", "3", "--stream-patience", "2",
         "--stream-eval-rows", "100", "--no-overlap", "--no-native-io",
         "--metrics-jsonl", "m.jsonl", "--device", "cpu"])
    assert (cfg.train_mode, cfg.shard_paths, cfg.prefetch_depth,
            cfg.stream_patience, cfg.stream_eval_rows, cfg.overlap,
            cfg.use_native_io, cfg.metrics_jsonl) == (
        "streaming", 64, 3, 2, 100, False, False, "m.jsonl")
    defaults = config_from_args(["e", "c", "n", "out"])
    assert (defaults.train_mode, defaults.shard_paths,
            defaults.prefetch_depth, defaults.stream_patience,
            defaults.stream_eval_rows, defaults.overlap,
            defaults.use_native_io, defaults.metrics_jsonl) == (
        "full", 0, 2, 5, 0, True, True, None)


@pytest.mark.parametrize("field,value", [
    ("train_mode", "minibatch"), ("shard_paths", -1), ("shard_paths", 3),
    ("prefetch_depth", 0), ("stream_patience", 0), ("stream_eval_rows", -1)])
def test_config_validation_matches_reference(field, value):
    with pytest.raises(ValueError, match=field):
        G2VecConfig(**{field: value}).validate()
    with pytest.raises(ValueError, match=field):
        JaxConfig(**{field: value}).validate()
