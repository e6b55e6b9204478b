"""The port's scenario engine (``g2vec_tpu_torch/stats``) against the JAX
package's (``g2vec_tpu/stats``), on the CPU.

- The reducers and ``write_stability``: the same numpy-seeded inputs
  through both packages give equal arrays, rows and bytes (exact).
- Plans: ``expand_plan``, ``scenario_id``, ``derive_seed`` and the
  config checks' messages are the JAX package's, and a scenario's
  validation error names its scenario and replicate as there.
- Each scenario end to end on ``--device cpu`` (tests/test_scenario.py's
  spec, f32, the native walker): a rerun's stability file is
  byte-identical; a replicate writes its solo run's three files byte for
  byte; every replicate's cohort and permuted labels are the JAX
  package's; a cold permutation scenario walks each group once
  (``walked=2``); the stability table equals the JAX reducer's on the
  port's lists (``t_obs``/``p``/``q``, ``acc_mean``/``acc_ci95``); the
  CV held-out sets cover every patient once.
- The CLI dispatch, a card-less ``--scenario`` run refused, and
  ``run_scenario_serve`` against a port daemon on a UNIX socket: one
  result record a replicate under its ``scn-<sid>-<name>`` key, a
  resubmission dedups, and the artifact is the lane path's bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from g2vec_tpu.batch import engine as jengine
from g2vec_tpu.config import G2VecConfig as JaxConfig
from g2vec_tpu.io import readers as jreaders
from g2vec_tpu.io import writers as jwriters
from g2vec_tpu import preprocess as jprep
from g2vec_tpu.stats import plan as jplan
from g2vec_tpu.stats import reduce as jred
from g2vec_tpu.stats import run as jrun
from g2vec_tpu_torch.batch import engine
from g2vec_tpu_torch.batch.engine import ManifestError, lane_config
from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.io import writers
from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs, run
from g2vec_tpu_torch import preprocess
from g2vec_tpu_torch.stats import plan, reduce as red
from g2vec_tpu_torch.stats.run import reduce_scenario, run_scenario

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
SUFFIXES = ("_biomarkers.txt", "_lgroups.txt", "_vectors.txt")


# ---------------------------------------------------------------------------
# Reducers and the writer
# ---------------------------------------------------------------------------

def _reducer_inputs(seed):
    rng = np.random.default_rng(seed)
    genes = [f"G{i:03d}" for i in range(30)]
    lists = [list(rng.choice(genes, size=8, replace=True))
             for _ in range(5)]
    good = rng.normal(size=(9, 30)).astype(np.float32)
    poor = rng.normal(loc=0.3, size=(7, 30)).astype(np.float32)
    good[:, 4] = poor[:, 4] = 2.0          # a zero-variance gene
    t_obs = rng.gamma(2.0, size=30)
    t_null = rng.gamma(2.0, size=(6, 30))
    t_null[:, 7] = t_obs[7]                # ties
    return dict(genes=genes, lists=lists, good=good, poor=poor, t_obs=t_obs,
                t_null=t_null, p=rng.uniform(size=30),
                accs=list(rng.uniform(0.4, 1.0, size=5)),
                x=rng.normal(size=(20, 4)), y=np.arange(20) % 2,
                ex=rng.normal(size=(9, 4)), ey=rng.integers(0, 2, size=9))


REDUCERS = {
    "np_tscores": lambda m, a: m.np_tscores(a["good"], a["poor"]),
    "perm_pvalues": lambda m, a: m.perm_pvalues(a["t_obs"], a["t_null"]),
    "bh_fdr": lambda m, a: m.bh_fdr(a["p"]),
    "selection_stats": lambda m, a: m.selection_stats(a["genes"],
                                                      a["lists"]),
    "percentile_ci": lambda m, a: m.percentile_ci(a["accs"]),
    "centroid_accuracy": lambda m, a: m.centroid_accuracy(
        a["x"], a["y"], a["ex"], a["ey"]),
    "reduce_selection": lambda m, a: m.reduce_selection(a["genes"],
                                                        a["lists"]),
    "reduce_permutation": lambda m, a: m.reduce_permutation(
        a["genes"], a["t_obs"], a["t_null"], a["lists"][0]),
    "reduce_cv": lambda m, a: m.reduce_cv(a["genes"], a["lists"],
                                          a["accs"]),
}


def _same(got, want):
    """Exact equality through tuples, dicts and arrays (NaN == NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)      # exact, NaN-aware
    else:
        assert got == want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_reducers_equal_the_jax_reducers(name, seed):
    args = _reducer_inputs(seed)
    _same(REDUCERS[name](red, args), REDUCERS[name](jred, args))


def test_write_stability_bytes_equal_the_jax_writer(tmp_path):
    args = _reducer_inputs(3)
    cols, rows, _ = red.reduce_permutation(args["genes"], args["t_obs"],
                                           args["t_null"], args["lists"][0])
    meta = [("scenario_id", "abc"), ("scenario_seed", 3),
            ("n_variants", 7), ("replicates", 6)]
    got = writers.write_stability(str(tmp_path / "port"), "permutation",
                                  meta, cols, args["genes"], rows)
    want = jwriters.write_stability(str(tmp_path / "jax"), "permutation",
                                    meta, cols, args["genes"], rows)
    assert got.endswith("port_stability.txt")
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    for mod in (writers, jwriters):
        with pytest.raises(ValueError, match="2 cells for 4 columns"):
            mod.write_stability(str(tmp_path / "bad"), "x", [], cols,
                                ["A"], [["1", "2"]])


# ---------------------------------------------------------------------------
# Plans, seeds, ids and the config checks
# ---------------------------------------------------------------------------

def _cfg_pair(**kw):
    base = dict(expression_file="E.tsv", clinical_file="C.tsv",
                network_file="N.tsv", result_name="out")
    base.update(kw)
    return G2VecConfig(**base), JaxConfig(**base)


PLANS = [("bootstrap", 4, 0, 9, {}), ("bootstrap", 3, 0, 1,
                                      {"patient_subsample": 0.8}),
         ("permutation", 5, 0, 9, {"seed": 5}),
         ("permutation", 2, 0, 0, {"compute_dtype": "float32"}),
         ("cv", 0, 3, 9, {}), ("cv", 0, 5, 11, {"lenPath": 20}),
         ("bootstrap", 3, 0, 2, {"expression_file": "/d/E.tsv",
                                 "result_name": "/tmp/o"})]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_plans_ids_and_seeds_equal_the_jax_plan(case):
    scn, reps, folds, sseed, kw = PLANS[case]
    cfg, jcfg = _cfg_pair(**kw)
    p = plan.ScenarioPlan(scn, replicates=reps, folds=folds,
                          scenario_seed=sseed)
    jp = jplan.ScenarioPlan(scn, replicates=reps, folds=folds,
                            scenario_seed=sseed)
    assert plan._ID_FIELDS == jplan._ID_FIELDS
    assert plan.expand_plan(p, cfg) == jplan.expand_plan(jp, jcfg)
    assert plan.scenario_id(p, cfg) == jplan.scenario_id(jp, jcfg)
    assert p.n_variants == jp.n_variants
    for i in range(4):
        for role in ("bootstrap", "permutation", "folds"):
            assert plan.derive_seed(sseed, i, role) == \
                jplan.derive_seed(sseed, i, role)
    sid, variants = plan.scenario_variants(p, cfg)
    jsid, jvariants = jplan.scenario_variants(jp, jcfg)
    assert sid == jsid
    assert [dataclasses.asdict(v) for v in variants] == \
        [dataclasses.asdict(v) for v in jvariants]


#: tests/test_scenario.py's config gates, and the rest of the reference's
#: scenario checks (g2vec_tpu/config.py:549-595).
CONFIG_CASES = {
    "no-replicates": dict(scenario="bootstrap"),
    "replicates-without-scenario": dict(replicates=3),
    "folds-without-scenario": dict(folds=2),
    "with-seeds": dict(scenario="bootstrap", replicates=2, batch_seeds=4),
    "with-manifest": dict(scenario="bootstrap", replicates=2,
                          manifest="m.json"),
    "cv-no-folds": dict(scenario="cv"),
    "cv-one-fold": dict(scenario="cv", folds=1),
    "cv-ok": dict(scenario="cv", folds=3),
    "permutation-ok": dict(scenario="permutation", replicates=5),
    "bootstrap-ok": dict(scenario="bootstrap", replicates=1),
    "cv-with-replicates": dict(scenario="cv", folds=3, replicates=2),
    "cv-with-subsample": dict(scenario="cv", folds=3,
                              patient_subsample=0.5),
    "permutation-with-folds": dict(scenario="permutation", replicates=2,
                                   folds=3),
    "streaming": dict(scenario="bootstrap", replicates=2,
                      train_mode="streaming"),
    "subsample-mode": dict(scenario="bootstrap", replicates=2,
                           subsample_mode="bootstrap"),
    "permute-seed": dict(scenario="permutation", replicates=2,
                         permute_seed=3),
    "negative-replicates": dict(replicates=-1),
    "negative-folds": dict(folds=-1),
    "unknown-scenario": dict(scenario="jackknife", replicates=2),
    "with-supervise": dict(scenario="bootstrap", replicates=2,
                           supervise=True),
    "with-checkpoint-dir": dict(scenario="cv", folds=2,
                                checkpoint_dir="ck"),
}


def _message(cfg):
    try:
        cfg.validate()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_checks_give_the_jax_messages(case):
    cfg, jcfg = _cfg_pair(**CONFIG_CASES[case])
    got, want = _message(cfg), _message(jcfg)
    assert got == want
    assert (got is None) == case.endswith("-ok")


def test_validation_errors_name_scenario_and_replicate():
    cfg, jcfg = _cfg_pair(patient_subsample=1.5)
    p = plan.ScenarioPlan("bootstrap", replicates=2)
    with pytest.raises(ManifestError) as e:
        plan.scenario_variants(p, cfg)
    with pytest.raises(jengine.ManifestError) as je:
        jplan.scenario_variants(jplan.ScenarioPlan("bootstrap",
                                                   replicates=2), jcfg)
    assert str(e.value) == str(je.value)
    assert f"scenario {plan.scenario_id(p, cfg)}" in str(e.value)
    assert "replicate 0" in str(e.value)
    with pytest.raises(ManifestError, match=r"^manifest variant 0:"):
        engine._variant_from_dict(0, {"subsample_mode": "bogus"},
                                  _cfg_pair()[0])
    with pytest.raises(ValueError, match="no --scenario"):
        plan.plan_from_config(_cfg_pair()[0])


# ---------------------------------------------------------------------------
# Scenarios end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("syn")))


def _cfg(tsv, root, sub, **overrides):
    os.makedirs(os.path.join(str(root), sub), exist_ok=True)
    kw = dict(expression_file=tsv["expression"],
              clinical_file=tsv["clinical"], network_file=tsv["network"],
              result_name=os.path.join(str(root), sub, "out"),
              lenPath=8, numRepetition=2, sizeHiddenlayer=16, epoch=30,
              learningRate=0.05, numBiomarker=5, compute_dtype="float32",
              kmeans_iters=50, seed=0, walker_backend="native",
              device="cpu")
    kw.update(overrides)
    return G2VecConfig(**kw)


KINDS = {"bootstrap": dict(scenario="bootstrap", replicates=3,
                           scenario_seed=11),
         "permutation": dict(scenario="permutation", replicates=2,
                             scenario_seed=5),
         "cv": dict(scenario="cv", folds=3, scenario_seed=5)}


@pytest.fixture(scope="module")
def scenarios(tsv, tmp_path_factory):
    """Each kind run once (a metrics stream each), and the JAX package's
    stages 1-2 of the same files."""
    root = tmp_path_factory.mktemp("scn")
    out = {}
    for kind, kw in KINDS.items():
        cfg = _cfg(tsv, root, kind, metrics_jsonl=os.path.join(
            str(root), f"{kind}.jsonl"), **kw)
        out[kind] = (cfg, run_scenario(cfg, console=lambda s: None))
    jdata = jreaders.load_expression(tsv["expression"])
    jdata.label = jprep.match_labels(
        jreaders.load_clinical(tsv["clinical"]), jdata.sample)
    network = jreaders.load_network(tsv["network"])
    jdata = jprep.restrict_data(jdata, jprep.find_common_genes(
        network.genes, jdata.gene))
    return root, out, jdata


def _lists(res):
    return {v.name: list(lane.biomarkers)
            for v, lane in zip(res.batch.variants, res.batch.lanes)}


def _jax_twin(cfg):
    """The JAX config and variants of a port scenario config."""
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(JaxConfig)
                        if hasattr(cfg, f.name) and f.name != "device"})
    return jcfg, jplan.scenario_variants(jplan.plan_from_config(jcfg),
                                         jcfg)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rerun_is_byte_identical_and_the_id_is_the_jax_id(kind, scenarios,
                                                          tsv):
    root, out, _ = scenarios
    cfg, res = out[kind]
    again = run_scenario(_cfg(tsv, root, kind + "_again", **KINDS[kind]),
                         console=lambda s: None)
    with open(res.output, "rb") as a, open(again.output, "rb") as b:
        assert a.read() == b.read()
    assert again.scenario_id == res.scenario_id == \
        _jax_twin(cfg)[1][0]
    with open(res.output) as f:
        assert f.readline() == \
            f"# g2vec stability v1\tscenario={kind}\n"


@pytest.mark.parametrize("kind,replicate", [("bootstrap", "b001"),
                                            ("permutation", "p001"),
                                            ("cv", "f02")])
def test_a_replicate_is_its_solo_runs_bytes(kind, replicate, scenarios,
                                            tsv):
    root, out, _ = scenarios
    cfg, res = out[kind]
    v = next(v for v in res.batch.variants if v.name == replicate)
    solo_cfg = lane_config(_cfg(tsv, root, kind + "_solo", **KINDS[kind]),
                           v)
    solo = run(solo_cfg, console=lambda s: None)
    for suffix in SUFFIXES:
        twin = next(p for p in solo.output_files if p.endswith(suffix))
        with open(f"{cfg.result_name}.{replicate}{suffix}", "rb") as a, \
                open(twin, "rb") as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cohorts_and_labels_are_the_jax_packages(kind, scenarios):
    _, out, jdata = scenarios
    cfg, res = out[kind]
    data, _, _ = preprocess_inputs(*read_inputs(cfg))
    _, (_, jvariants) = _jax_twin(cfg)
    for v, jv in zip(res.batch.variants, jvariants):
        assert v.expr_key() == jv.expr_key()
        if v.expr_key() is None:
            continue
        got = engine._lane_cohort(data, v)
        want = jengine._lane_cohort(jdata, jv)
        np.testing.assert_array_equal(got.expr, want.expr)
        np.testing.assert_array_equal(got.label, want.label)
        np.testing.assert_array_equal(got.sample, want.sample)
    for v in res.batch.variants:
        if v.permute_seed is not None:
            np.testing.assert_array_equal(
                preprocess.permute_labels(data.label, v.permute_seed),
                jprep.permute_labels(jdata.label, v.permute_seed))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_table_is_the_jax_reduction_of_the_same_lists(kind,
                                                          scenarios):
    _, out, jdata = scenarios
    cfg, res = out[kind]
    jcfg, (sid, jvariants) = _jax_twin(cfg)
    data, _, _ = preprocess_inputs(*read_inputs(cfg))
    # The JAX reducer is the oracle, on the port's lists.
    _, cols, rows, extras = jrun.reduce_scenario(
        jplan.plan_from_config(jcfg), jcfg, jdata, jvariants, _lists(res))
    genes, pcols, prows, pextras = reduce_scenario(
        plan.plan_from_config(cfg), cfg, data, res.batch.variants,
        _lists(res))
    assert (pcols, prows) == (cols, rows)
    _same(pextras, extras)
    with open(res.output) as f:
        lines = f.read().splitlines()
    meta = dict(ln[2:].split("\t") for ln in lines if ln.startswith("# ")
                and "\t" in ln[2:])
    assert meta["scenario_id"] == sid
    body = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    assert body[0] == ["GeneSymbol"] + cols
    assert [r[1:] for r in body[1:]] == rows
    assert [r[0] for r in body[1:]] == genes
    if kind == "cv":
        assert meta["acc_mean"] == "%.6f" % extras["acc_mean"]
        assert meta["acc_ci95"] == "%.6f,%.6f" % (extras["ci_lo"],
                                                  extras["ci_hi"])
        assert 0.0 <= extras["ci_lo"] <= extras["acc_mean"] \
            <= extras["ci_hi"] <= 1.0


def test_permutation_walks_each_group_once_and_emits_the_events(
        scenarios):
    _, out, _ = scenarios
    cfg, res = out["permutation"]
    assert res.n_variants == 3
    assert res.walk_stats["walked"] == 2
    assert res.walk_stats["lane_shared"] == 4       # 3 lanes x 2 - 2
    ps = np.array([float(r.split("\t")[2]) for r in
                   open(res.output).read().splitlines()
                   if not r.startswith(("#", "Gene"))])
    assert ps.min() >= 1 / 3 - 1e-6 and ps.max() <= 1.0
    with open(cfg.metrics_jsonl) as f:
        kinds = [json.loads(ln)["event"] for ln in f]
    assert kinds.count("scenario") == 1
    assert kinds.count("replicate") == 3
    assert kinds.count("stability") == 1


def test_cv_held_out_sets_cover_every_patient_once(scenarios):
    _, out, jdata = scenarios
    cfg, res = out["cv"]
    data, _, _ = preprocess_inputs(*read_inputs(cfg))
    seed = plan.derive_seed(5, 0, "folds")
    folds = preprocess.fold_assignments(data.label, 3, seed)
    np.testing.assert_array_equal(
        folds, jprep.fold_assignments(jdata.label, 3, seed))
    held = []
    for v in res.batch.variants:
        train = engine._lane_cohort(data, v)
        held.append(set(data.sample) - set(train.sample))
    assert set().union(*held) == set(data.sample)
    assert sum(len(h) for h in held) == len(data.sample)


# ---------------------------------------------------------------------------
# The CLI and the serve path
# ---------------------------------------------------------------------------

def _cli(tsv, out, *extra):
    return subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch", tsv["expression"],
         tsv["clinical"], tsv["network"], out, "-p", "8", "-r", "2", "-s",
         "16", "-e", "10", "-l", "0.05", "-n", "5", "--compute-dtype",
         "float32", "--walker-backend", "native", "--kmeans-iters", "50",
         "--scenario", "bootstrap", "--replicates", "2",
         "--scenario-seed", "3", *extra],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""))


def test_cli_dispatch_writes_the_in_process_bytes(tsv, tmp_path):
    out = str(tmp_path / "cli" / "out")
    os.makedirs(os.path.dirname(out))
    proc = _cli(tsv, out, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "scenario bootstrap" in proc.stdout
    res = run_scenario(_cfg(tsv, tmp_path, "lib", epoch=10, scenario_seed=3,
                            scenario="bootstrap", replicates=2),
                       console=lambda s: None)
    with open(out + "_stability.txt", "rb") as a, \
            open(res.output, "rb") as b:
        assert a.read() == b.read()
    # No card and no --device cpu: the run raises, nothing is written.
    nocard = str(tmp_path / "nocard" / "out")
    os.makedirs(os.path.dirname(nocard))
    proc = _cli(tsv, nocard)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not os.path.exists(nocard + "_stability.txt")


def test_scenario_over_a_daemon_dedups_and_equals_the_lane_path(tsv,
                                                                tmp_path):
    from g2vec_tpu_torch.serve import client, daemon
    from g2vec_tpu_torch.stats.serve import run_scenario_serve

    state = str(tmp_path / "state")
    d = daemon.ServeDaemon(daemon.ServeOptions(
        socket_path=str(tmp_path / "g.sock"), state_dir=state,
        device="cpu"), console=lambda s: None)
    th = threading.Thread(target=d.serve_forever, daemon=True)
    th.start()
    try:
        assert client.wait_ready(d.opts.socket_path, deadline_s=30)
        os.makedirs(tmp_path / "srv")
        base = dict(expression_file=tsv["expression"],
                    clinical_file=tsv["clinical"],
                    network_file=tsv["network"],
                    result_name=str(tmp_path / "srv" / "out"),
                    lenPath=8, numRepetition=2, sizeHiddenlayer=16,
                    epoch=10, learningRate=0.05, numBiomarker=5,
                    compute_dtype="float32", walker_backend="native",
                    kmeans_iters=50)
        kw = dict(scenario="bootstrap", replicates=2, scenario_seed=11,
                  state_dir=state, timeout=120, poll_deadline_s=120,
                  console=lambda s: None,
                  metrics_jsonl=str(tmp_path / "srv.jsonl"))
        res = run_scenario_serve(d.opts.socket_path, base, **kw)
        results = os.path.join(state, "results")
        recs = []
        for fn in sorted(os.listdir(results)):
            with open(os.path.join(results, fn)) as f:
                recs.append(json.load(f))
        assert sorted(r["idem_key"] for r in recs) == [
            f"scn-{res.scenario_id}-b000", f"scn-{res.scenario_id}-b001"]
        assert all(r["status"] == "done" for r in recs)
        with open(res.output, "rb") as f:
            art = f.read()
        again = run_scenario_serve(d.opts.socket_path, base, **kw)
        with open(again.output, "rb") as f:
            assert f.read() == art
        assert len(os.listdir(results)) == 2
        assert d.jobs_done == 2
        lane = run_scenario(_cfg(tsv, tmp_path, "lane", epoch=10,
                                 scenario="bootstrap", replicates=2,
                                 scenario_seed=11),
                            console=lambda s: None)
        assert lane.scenario_id == res.scenario_id
        with open(lane.output, "rb") as f:
            assert f.read() == art
        with open(tmp_path / "srv.jsonl") as f:      # the second call's
            evs = [json.loads(ln) for ln in f]
        assert [e["via"] for e in evs if e["event"] == "scenario"] == \
            ["serve"]
        assert [e["name"] for e in evs if e["event"] == "replicate"] == \
            ["b000", "b001"]
    finally:
        d._stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        d.close()
