"""The port's batch engine (``g2vec_tpu_torch.batch``) on the CPU.

Its contract: every lane's three output files are the bytes the port's
solo ``pipeline.run(lane_config(cfg, v))`` writes. Held here for a seed
sweep (one bucket, lanes stopping at different epochs), a manifest of
patient subsamples, a CV fold, a bootstrap draw, a permutation null and a
learning-rate variant (several buckets, one-lane buckets among them), at
float32 and on the bf16 plain path, and for streaming lanes. Besides:

- the manifest errors are the JAX package's, message for message, on the
  same bad manifests, and so are the cohort functions' results (rows,
  fold ids, permuted labels) for the same seeds;
- a profiled batch's trace holds its six stage ranges, and a walked
  product is one walk span;
- the walk accounting (walked, lane-shared, memo and disk hits) and a
  second ``ResidentEngine.execute`` served from the resident dataset and
  the walk memo, writing the same bytes;
- the CLI flags reach the config, and the metrics stream's records parse;
- the trainers run the caller's ``check`` hook (an exception stops the
  batch), and streaming lanes report ``lifecycle`` events under their job
  ids.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from g2vec_tpu import preprocess as jprep
from g2vec_tpu.batch import engine as jengine
from g2vec_tpu.config import G2VecConfig as JaxConfig
from g2vec_tpu.data.synthetic import SyntheticSpec as JaxSpec
from g2vec_tpu.data.synthetic import make_synthetic
from g2vec_tpu_torch import preprocess as tprep
from g2vec_tpu_torch.batch import engine as tengine
from g2vec_tpu_torch.config import G2VecConfig, config_from_args
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.io.readers import ExpressionData
from g2vec_tpu_torch.pipeline import run

pytestmark = pytest.mark.torch

SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
MIXED = [
    {"name": "full"},
    {"name": "subA", "patient_subsample": 0.8, "subsample_seed": 3},
    {"name": "subB", "patient_subsample": 0.8, "subsample_seed": 9},
    {"name": "fold1", "subsample_mode": "fold", "cv_folds": 3, "cv_fold": 1,
     "subsample_seed": 2},
    {"name": "boot", "subsample_mode": "bootstrap", "subsample_seed": 4},
    {"name": "null", "permute_seed": 5, "train_seed": 3},
    {"name": "fast", "learningRate": 0.02},
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("syn")))


def _cfg(files, out, **overrides):
    base = dict(expression_file=files["expression"],
                clinical_file=files["clinical"],
                network_file=files["network"],
                result_name=os.path.join(str(out), "batch", "out"),
                lenPath=8, numRepetition=2, sizeHiddenlayer=16, epoch=30,
                learningRate=0.05, numBiomarker=5, compute_dtype="float32",
                kmeans_iters=50, seed=0, device="cpu")
    base.update(overrides)
    return G2VecConfig(**base)


def _read(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def _assert_lanes_are_solo_runs(cfg, res, out):
    solo_dir = os.path.join(str(out), "solo")
    os.makedirs(solo_dir, exist_ok=True)
    for v, lane in zip(res.variants, res.lanes):
        solo_cfg = tengine.lane_config(dataclasses.replace(
            cfg, manifest=None, batch_seeds=0, metrics_jsonl=None,
            result_name=os.path.join(solo_dir, "out")), v)
        solo = run(solo_cfg, console=lambda s: None)
        assert _read(lane.output_files) == _read(solo.output_files), v.name
        assert len(lane.train_history) == len(solo.train_history)
        assert lane.n_paths == solo.n_paths
        assert lane.n_samples == solo.n_samples
    return [len(lane.train_history) for lane in res.lanes]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_seed_sweep_lanes_are_solo_runs(files, tmp_path, compute_dtype):
    cfg = _cfg(files, tmp_path, batch_seeds=3, compute_dtype=compute_dtype)
    res = tengine.run_batch(cfg, console=lambda s: None)
    # 6 lane-walks, 2 distinct products (the walk seed is shared).
    assert res.walk_stats == {"memo_hits": 0, "disk_hits": 0, "walked": 2,
                              "lane_shared": 4}
    assert [(b["lanes"], b["mode"]) for b in res.buckets] == [(3, "lanes")]
    epochs = _assert_lanes_are_solo_runs(cfg, res, tmp_path)
    assert len(set(epochs)) > 1, epochs
    assert len({_read(lane.output_files)[2] for lane in res.lanes}) == 3
    assert res.runs_per_hour > 0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mixed_manifest_lanes_are_solo_runs(files, tmp_path, compute_dtype):
    mpath = str(tmp_path / "manifest.json")
    with open(mpath, "w") as f:
        json.dump(MIXED, f)
    cfg = _cfg(files, tmp_path, manifest=mpath, compute_dtype=compute_dtype)
    res = tengine.run_batch(cfg, console=lambda s: None)
    # Cohorts: full (full, null, fast share it), subA, subB, fold1, boot.
    assert res.walk_stats == {"memo_hits": 0, "disk_hits": 0, "walked": 10,
                              "lane_shared": 4}
    assert sum(b["lanes"] for b in res.buckets) == len(MIXED)
    assert {b["mode"] for b in res.buckets} == {"lanes", "solo"}
    # Each walked product is one walk span, with its row set inside.
    walks = res.stage_extras["paths"]["span_n"]
    assert walks["walk_g"] + walks["walk_p"] == 10
    assert walks["walk_g/row_set"] + walks["walk_p/row_set"] == 10
    _assert_lanes_are_solo_runs(cfg, res, tmp_path)
    by_name = {v.name: lane for v, lane in zip(res.variants, res.lanes)}
    assert by_name["fold1"].n_samples < by_name["full"].n_samples
    # The null scores against shuffled labels on the full cohort's walks.
    assert by_name["null"].n_paths == by_name["full"].n_paths
    assert _read(by_name["null"].output_files)[0] != \
        _read(by_name["full"].output_files)[0]


def test_resident_engine_serves_a_second_batch_from_memory(files, tmp_path):
    cache = str(tmp_path / "cache")
    cfg = _cfg(files, tmp_path, batch_seeds=2)
    lines = []
    with tengine.ResidentEngine(cache_dir=cache) as engine:
        first = engine.execute(cfg, console=lines.append)
        again = engine.execute(cfg, console=lines.append)
        status = engine.status()
    assert first.walk_stats["walked"] == 2
    assert again.walk_stats == {"memo_hits": 2, "disk_hits": 0, "walked": 0,
                                "lane_shared": 2}
    assert sum("dataset resident" in line for line in lines) == 1
    for a, b in zip(first.lanes, again.lanes):
        assert _read(a.output_files) == _read(b.output_files)
    assert (status["batches_executed"], status["lanes_executed"],
            status["datasets_resident"], status["walk_products_resident"]) \
        == (2, 4, 1, 2)
    assert status["warm_shapes"] == [
        {"n_paths": first.lanes[0].n_paths, "lanes": 2, "hidden": 16,
         "learning_rate": 0.05, "max_epochs": 30}]
    # A new engine over the same cache hits the disk tier, and a walk seed
    # of its own walks both its products again.
    mpath = str(tmp_path / "rewalk.json")
    with open(mpath, "w") as f:
        json.dump([{"name": "base"}, {"name": "other", "seed": 5}], f)
    with tengine.ResidentEngine(cache_dir=cache) as engine:
        mixed = engine.execute(_cfg(files, tmp_path / "rw", manifest=mpath),
                               console=lambda s: None)
    assert (mixed.walk_stats["disk_hits"], mixed.walk_stats["walked"]) == \
        (2, 2)


def test_a_profiled_batch_has_stage_ranges(files, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(files, tmp_path, batch_seeds=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tengine.run_batch(cfg, console=lambda s: None)
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {n for n in names if n.startswith("stage:")} == {
        f"stage:{s}" for s in ("load", "paths", "train", "lgroups",
                               "biomarkers", "save")}
    assert {"span:load/read_network", "span:paths/walk_g/row_set"} <= names
    assert res.stage_extras["load"]["span_n"] == {
        "read_expression": 1, "read_clinical": 1, "read_network": 1}


def test_streaming_lanes_are_solo_streaming_runs(files, tmp_path):
    cfg = _cfg(files, tmp_path, batch_seeds=2, train_mode="streaming",
               shard_paths=16)
    res = tengine.run_batch(cfg, console=lambda s: None)
    assert [b["mode"] for b in res.buckets] == ["stream-solo"] * 2
    _assert_lanes_are_solo_runs(cfg, res, tmp_path)


def test_metrics_stream_records(files, tmp_path):
    mj = str(tmp_path / "m.jsonl")
    cfg = _cfg(files, tmp_path, batch_seeds=3, metrics_jsonl=mj)
    res = tengine.run_batch(cfg, console=lambda s: None)
    with open(mj) as f:
        events = [json.loads(line) for line in f]
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert events[0]["event"] == "batch_config"
    assert events[0]["n_lanes"] == 3 and events[0]["lanes_cap"] == 8
    tags = {v.tag() for v in res.variants}
    lane_events = [e for e in events if "lane" in e]
    assert {e["lane"] for e in lane_events} == tags
    for tag in tags:
        kinds = {e["event"] for e in lane_events if e["lane"] == tag}
        assert {"lane_variant", "paths", "epoch", "train_done",
                "done"} <= kinds
    done = [e for e in events if e["event"] == "done" and "lane" not in e]
    assert len(done) == 1 and done[0]["runs_per_hour"] > 0
    assert done[0]["walk_stats"] == res.walk_stats
    for e in lane_events:
        if e["event"] == "train_done":
            assert done[0]["stop_epochs"][e["lane"]] == e["stop_epoch"]
    assert [e for e in events if e["event"] == "batch_walks"][0][
        "n_walk_tasks"] == 2


def _bad_manifests(tmp_path):
    docs = [[{"learning_rate": 0.1}], [{}, {"train_seed": -1}],
            [{"learningRate": 0}], [{"patient_subsample": 1.5}],
            {"variants": []}, [{"name": "a"}, {"name": "a"}],
            [{"name": "bad name!"}], [{"subsample_mode": "fold"}],
            [{"subsample_mode": "fold", "cv_folds": 3, "cv_fold": 3}],
            [{"subsample_mode": "fold", "cv_folds": 3,
              "patient_subsample": 0.5}],
            [{"cv_fold": 1}], [{"permute_seed": -2}],
            [{"subsample_mode": "jackknife"}], [3], [{"epoch": 0}]]
    paths = []
    for i, doc in enumerate(docs):
        p = str(tmp_path / f"bad{i}.json")
        with open(p, "w") as f:
            json.dump(doc, f)
        paths.append(p)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    return paths + [bad, str(tmp_path / "missing.json")]


def test_manifest_errors_are_the_reference_messages(tmp_path):
    cfg, jcfg = G2VecConfig(), JaxConfig()
    for path in _bad_manifests(tmp_path):
        with pytest.raises(tengine.ManifestError) as got:
            tengine.load_manifest(path, cfg)
        with pytest.raises(jengine.ManifestError) as want:
            jengine.load_manifest(path, jcfg)
        assert str(got.value) == str(want.value)
    good = str(tmp_path / "good.json")
    with open(good, "w") as f:
        json.dump(MIXED, f)
    assert [dataclasses.asdict(v) for v in tengine.load_manifest(good, cfg)] \
        == [dataclasses.asdict(v) for v in jengine.load_manifest(good, jcfg)]
    sweep = tengine.seed_sweep_variants(G2VecConfig(train_seed=4), 3)
    assert [(v.name, v.train_seed, v.kmeans_seed, v.tag()) for v in sweep] \
        == [(v.name, v.train_seed, v.kmeans_seed, v.tag()) for v in
            jengine.seed_sweep_variants(JaxConfig(train_seed=4), 3)]
    with pytest.raises(tengine.ManifestError, match="needs --manifest"):
        tengine.plan_variants(cfg)


def test_cohorts_are_the_reference_rows():
    data = make_synthetic(JaxSpec(**dataclasses.asdict(SPEC)))[0]
    labels = np.array([0] * 24 + [1] * 20, dtype=np.int32)
    jdata = dataclasses.replace(data, label=labels)
    tdata = ExpressionData(sample=jdata.sample, gene=jdata.gene,
                           expr=jdata.expr, label=labels)
    for seed in (0, 3, 17):
        for frac, repl in ((0.8, False), (0.5, True), (1.0, True)):
            got = tprep.subsample_patients(tdata, frac, seed, repl)
            want = jprep.subsample_patients(jdata, frac, seed, repl)
            assert got.sample.tolist() == want.sample.tolist()
            assert got.expr.tobytes() == want.expr.tobytes()
            assert got.label.tobytes() == want.label.tobytes()
        for k in (2, 3, 5):
            assert tprep.fold_assignments(labels, k, seed).tobytes() == \
                jprep.fold_assignments(labels, k, seed).tobytes()
            got = tprep.fold_cohort(tdata, k, k - 1, seed)
            want = jprep.fold_cohort(jdata, k, k - 1, seed)
            assert got.sample.tolist() == want.sample.tolist()
            assert got.expr.tobytes() == want.expr.tobytes()
        assert tprep.permute_labels(labels, seed).tobytes() == \
            jprep.permute_labels(labels, seed).tobytes()
    for fn, args, match in (
            (tprep.subsample_patients, (tdata, 0.0, 0), "fraction"),
            (tprep.fold_assignments, (labels, 1, 0), "n_folds"),
            (tprep.fold_assignments, (labels, 30, 0), "cannot stratify"),
            (tprep.fold_assignments, (np.array([0, 0, 0, 1, 1, 1]), 2, 0),
             "training split"),
            (tprep.fold_cohort, (tdata, 3, 3, 0), "fold must be")):
        with pytest.raises(ValueError, match=match):
            fn(*args)
    spec = G2VecConfig(subsample_mode="fold", cv_folds=4, cv_fold=2,
                       subsample_seed=1)
    assert tprep.select_cohort(tdata, spec).sample.tolist() == \
        jengine._lane_cohort(jdata, spec).sample.tolist()
    assert tprep.select_cohort(tdata, G2VecConfig()) is tdata


def test_cli_flags_reach_the_config():
    cfg = config_from_args([
        "E", "C", "N", "R", "--seeds", "4", "--lanes", "3",
        "--train-seed", "9", "--kmeans-seed", "2",
        "--patient-subsample", "0.5", "--subsample-seed", "11"])
    assert (cfg.batch_seeds, cfg.lanes, cfg.train_seed, cfg.kmeans_seed,
            cfg.patient_subsample, cfg.subsample_seed) == (4, 3, 9, 2,
                                                           0.5, 11)
    cfg = config_from_args([
        "E", "C", "N", "R", "--manifest", "m.json", "--subsample-mode",
        "fold", "--cv-folds", "5", "--cv-fold", "4", "--permute-seed", "7"])
    assert (cfg.manifest, cfg.subsample_mode, cfg.cv_folds, cfg.cv_fold,
            cfg.permute_seed) == ("m.json", "fold", 5, 4, 7)
    # The scenario engine's flags (stats/): they reach the config, the
    # config checks refuse a half scenario, argparse an unknown one.
    cfg = config_from_args(["E", "C", "N", "R", "--scenario", "cv",
                            "--folds", "3", "--scenario-seed", "4"])
    assert (cfg.scenario, cfg.folds, cfg.replicates, cfg.scenario_seed) \
        == ("cv", 3, 0, 4)
    cfg = config_from_args(["E", "C", "N", "R", "--scenario", "bootstrap",
                            "--replicates", "2"])
    assert (cfg.scenario, cfg.replicates) == ("bootstrap", 2)
    for flag, match in ((["--scenario", "cv"], "--folds >= 2"),
                        (["--replicates", "2"], "need --scenario"),
                        (["--folds", "3"], "need --scenario")):
        with pytest.raises(ValueError, match=match):
            config_from_args(["E", "C", "N", "R", *flag])
    with pytest.raises(SystemExit):
        config_from_args(["E", "C", "N", "R", "--scenario", "jackknife"])


@pytest.mark.parametrize("overrides", [
    dict(manifest="m.json", batch_seeds=2), dict(batch_seeds=2, lanes=0),
    dict(batch_seeds=-1), dict(patient_subsample=1.5),
    dict(subsample_mode="loo"),
    dict(subsample_mode="fold", cv_folds=1),
    dict(subsample_mode="fold", cv_folds=3, cv_fold=3),
    dict(subsample_mode="fold", cv_folds=3, patient_subsample=0.5),
    dict(cv_folds=3), dict(permute_seed=-1)])
def test_config_validation_is_the_reference_message(overrides):
    with pytest.raises(ValueError) as got:
        G2VecConfig(**overrides).validate()
    with pytest.raises(ValueError) as want:
        JaxConfig(**overrides).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides,flag", [
    (dict(batch_seeds=2, supervise=True), "--supervise"),
    (dict(batch_seeds=2, checkpoint_dir="ck"), "--checkpoint-dir"),
    (dict(manifest="m", resume=True), "--resume")])
def test_batch_refuses_supervision_and_checkpoints(overrides, flag):
    with pytest.raises(ValueError, match=f"does not compose with {flag}"):
        G2VecConfig(**overrides).validate()


def test_check_and_lifecycle_reach_the_trainers(files, tmp_path):
    base = _cfg(files, tmp_path)
    variants = tengine.seed_sweep_variants(base, 2)
    calls, events = [], []
    with tengine.ResidentEngine() as engine:
        full = engine.execute(base, variants, console=lambda s: None,
                              check=lambda: calls.append("full"))
        stream_cfg = _cfg(files, tmp_path / "s", train_mode="streaming",
                          shard_paths=16,
                          checkpoint_dir=str(tmp_path / "ck"))
        engine.execute(stream_cfg, variants, console=lambda s: None,
                       lane_jobs=["j0", "j1"],
                       check=lambda: calls.append("stream"),
                       lifecycle=lambda jid, state, info: events.append(
                           (jid, state, info["done"])))
        status = engine.status()

        def stop():
            raise RuntimeError("stop requested")

        with pytest.raises(RuntimeError, match="stop requested"):
            engine.execute(base, variants, console=lambda s: None,
                           check=stop)
    # One check a lane trainer epoch (the bucket's), before each.
    assert calls.count("full") == max(len(lane.train_history)
                                      for lane in full.lanes) + 1
    assert calls.count("stream") > 0
    assert {jid for jid, _, _ in events} == {"j0", "j1"}
    assert {state for _, state, _ in events} == {"checkpointed"}
    for lane in ("s0", "s1"):
        assert (tmp_path / "ck" / lane / "stream_state.npz").exists()
    assert status["stream"]["runs"] >= 2 and status["stream"]["epochs"] > 0
