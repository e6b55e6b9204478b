"""The port's seven-stage solo run against the JAX package, stage by stage.

The golden spec of tests/test_golden_e2e.py goes through
``g2vec_tpu_torch.pipeline.run`` on the CPU with ``compute_dtype=
"float32"`` and through a composition of the JAX package's own stage
functions, both given the same injected values: one numpy init of the
CBOW (the JAX trainer through ``warm_start``) and the same ten k-means
starting centres (the JAX side runs ``jax.vmap(_lloyd)`` over them and
keeps the restart with the lowest inertia, as ``kmeans`` does).

- ``_lgroups.txt`` and ``_biomarkers.txt`` are byte-equal;
- ``_vectors.txt`` agrees value by value within 2e-6 absolute: the
  trainers agree at rtol 1e-5 (tests/test_torch_trainer.py) and the file
  prints six decimals, so a value may land one printed digit apart;
- the transcript's ``n_samples``, ``n_genes``, ``n_edges``, ``n_paths``
  and path-gene lines equal those of ``g2vec_tpu.pipeline.run``.

The streaming run (``train_mode="streaming"``) goes through the port's
pipeline and through ``g2vec_tpu.train.stream.train_cbow_streaming``
composed with the same stage 5-7 functions. The JAX streaming trainer
draws its own init from ``jax.random.key(seed)``; the port is given that
draw. Its ``_lgroups.txt`` and ``_biomarkers.txt`` are byte-equal, and
the path count, votes and stop epoch equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from g2vec_tpu import analysis as janalysis
from g2vec_tpu.config import G2VecConfig as JaxConfig
from g2vec_tpu.data.synthetic import write_synthetic_tsv as jax_write_tsv
from g2vec_tpu.io import readers as jreaders
from g2vec_tpu.io import writers as jwriters
from g2vec_tpu.ops import graph as jgraph
from g2vec_tpu.ops import host_walker as jwalker
from g2vec_tpu.ops import kmeans as jkmeans
from g2vec_tpu.ops import walker as jpaths
from g2vec_tpu.models.cbow import init_params as jax_init_params
from g2vec_tpu.train.stream import train_cbow_streaming as jax_stream
from g2vec_tpu import preprocess as jprep
from g2vec_tpu.train.trainer import train_cbow as jax_train
from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.pipeline import run

pytestmark = pytest.mark.torch

SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
ARGS = dict(lenPath=20, numRepetition=3, sizeHiddenlayer=16, epoch=30,
            numBiomarker=10, seed=11)
SUFFIXES = ("biomarkers", "lgroups", "vectors")


def _jax_inputs(files):
    """Stages 1-2 from the JAX package's stage functions."""
    data = jreaders.load_expression(files["expression"])
    data.label = jprep.match_labels(jreaders.load_clinical(files["clinical"]),
                                    data.sample)
    network = jreaders.load_network(files["network"])
    common = jprep.find_common_genes(network.genes, data.gene)
    network = jprep.restrict_network(network, common)
    data = jprep.restrict_data(data, common)
    src, dst = jprep.edges_to_indices(network, jprep.make_gene2idx(data.gene))
    return data, src, dst


def _jax_composition(files, result_name, init, centers0):
    """Stages 1-7 from the JAX package's stage functions, with the
    injected CBOW init and k-means starting centres; returns the training
    result, the written files and stage 3's packed rows and labels."""
    data, src, dst = _jax_inputs(files)
    n_genes = len(data.gene)

    sets = []
    for i in range(2):
        edges = jgraph.thresholded_edges(data.expr[data.label == i], src, dst,
                                         0.5)
        sets.append(jwalker.generate_path_set_native(
            *(np.asarray(a) for a in edges), n_genes, len_path=ARGS["lenPath"],
            reps=ARGS["numRepetition"], seed=(ARGS["seed"] << 1) | i))
    paths, labels = jpaths.integrate_path_sets(sets[0], sets[1], n_genes,
                                               packed=True)
    gene_freq = jpaths.count_gene_freq(paths, labels, data.gene, packed=True)

    trained = jax_train(paths, labels, packed_genes=n_genes,
                        hidden=ARGS["sizeHiddenlayer"], learning_rate=0.005,
                        max_epochs=ARGS["epoch"], compute_dtype="float32",
                        seed=ARGS["seed"], warm_start=init)
    return trained, _jax_stages_5_to_7(data, trained.w_ih, gene_freq,
                                       centers0, result_name), (paths, labels)


def _jax_stages_5_to_7(data, w_ih, gene_freq, centers0, result_name):
    """Stages 5-7 from the JAX package's stage functions on a trained
    embedding, with the injected k-means starting centres; returns the
    written files."""
    emb = jnp.asarray(w_ih)
    c_all, inertia = jax.vmap(lambda c: jkmeans._lloyd(emb, c, 300))(
        jnp.asarray(centers0))
    best = c_all[int(jnp.argmin(inertia))]
    km = jnp.argmin(jkmeans._pairwise_sq_dists(emb, best), axis=1)
    counts, good, poor = janalysis._vote_counts(
        km, jnp.asarray(janalysis.freq_index(data.gene, gene_freq)), 3)
    gc, pc = janalysis._pick_clusters(np.asarray(counts), np.asarray(good),
                                      np.asarray(poor), 3, False)
    lgroup = np.asarray(janalysis._renumber(km, gc, pc))

    scores2 = np.asarray(janalysis.biomarker_scores_device(
        emb, data.expr[data.label == 0], data.expr[data.label == 1], lgroup,
        0.5))
    biomarkers, _ = janalysis.top_biomarkers(scores2, lgroup, data.gene,
                                             ARGS["numBiomarker"])
    return [
        jwriters.write_biomarkers(result_name, biomarkers),
        jwriters.write_lgroups(result_name, lgroup, data.gene),
        jwriters.write_vectors(result_name, w_ih, data.gene),
    ]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    files = write_synthetic_tsv(SPEC, str(tmp))
    rng = np.random.default_rng(5)
    n_common = len(jprep.find_common_genes(
        jreaders.load_network(files["network"]).genes,
        jreaders.load_expression(files["expression"]).gene))
    hidden = ARGS["sizeHiddenlayer"]
    init = ((np.clip(rng.standard_normal((n_common, hidden)), -2, 2)
             / np.sqrt(hidden)).astype(np.float32),
            (np.clip(rng.standard_normal((hidden, 1)), -2, 2)
             / np.sqrt(hidden)).astype(np.float32))
    # Starting centres drawn from the init rows: the never-trained genes
    # stay near them, so the restarts start inside the data's range.
    centers0 = init[0][rng.choice(n_common, size=(10, 3), replace=True)]

    trained, jax_files, jax_rows = _jax_composition(files, str(tmp / "jax"), init,
                                          centers0)
    lines = []
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp / "port"), compute_dtype="float32",
                      device="cpu", **ARGS)
    result = run(cfg, console=lines.append, init=init,
                 kmeans_centers0=centers0)
    return dict(files=files, tmp=tmp, trained=trained, jax_files=jax_files,
                jax_rows=jax_rows, result=result, lines=lines,
                centers0=centers0, init=init)


def test_synthetic_tsvs_are_byte_identical_to_jax(both_runs, tmp_path):
    jax_files = jax_write_tsv(SPEC, str(tmp_path))
    for name, path in both_runs["files"].items():
        with open(path, "rb") as a, open(jax_files[name], "rb") as b:
            assert a.read() == b.read(), name


def test_stage3_rows_match_the_jax_composition(both_runs):
    paths, labels = both_runs["jax_rows"]
    result = both_runs["result"]
    assert result.paths.shape == (result.n_paths, (result.n_genes + 7) // 8)
    assert np.array_equal(result.paths, paths)
    assert np.array_equal(result.labels, labels)


def test_training_matches_the_jax_composition(both_runs):
    trained, result = both_runs["trained"], both_runs["result"]
    assert len(trained.history) >= 3
    assert result.stop_epoch == trained.stop_epoch
    assert [(h["acc_val"], h["acc_tr"]) for h in result.train_history] == \
        [(h["acc_val"], h["acc_tr"]) for h in trained.history]
    np.testing.assert_allclose(result.embeddings, trained.w_ih, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("suffix", ["biomarkers", "lgroups"])
def test_selection_files_are_byte_equal(both_runs, suffix):
    port = both_runs["result"].output_files[SUFFIXES.index(suffix)]
    ref = both_runs["jax_files"][SUFFIXES.index(suffix)]
    with open(port, "rb") as a, open(ref, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    # A real selection: every L-group is populated on this spec.
    if suffix == "lgroups":
        groups = {line.split("\t")[1] for line in got.decode().splitlines()[1:]}
        assert groups == {"0", "1", "2"}


def test_vectors_agree_within_printed_precision(both_runs):
    port = both_runs["result"].output_files[2]
    ref = both_runs["jax_files"][2]
    with open(port) as a, open(ref) as b:
        got, want = a.read().splitlines(), b.read().splitlines()
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        g_fields, w_fields = g.split("\t"), w.split("\t")
        assert g_fields[0] == w_fields[0]
        np.testing.assert_allclose(np.array(g_fields[1:], float),
                                   np.array(w_fields[1:], float),
                                   rtol=0, atol=2e-6)


def test_transcript_counts_match_jax_pipeline(both_runs, tmp_path):
    from g2vec_tpu.pipeline import run as jax_run

    files = both_runs["files"]
    jax_lines = []
    jax_run(JaxConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp_path / "jax_run"),
                      walker_backend="native", compute_dtype="float32",
                      **dict(ARGS, epoch=2)),
            console=jax_lines.append)

    def counts(lines):
        return [ln for ln in lines if ln.startswith("    n_")]

    assert len(counts(jax_lines)) == 5
    assert counts(both_runs["lines"]) == counts(jax_lines)
    stages = [ln for ln in both_runs["lines"] if ln.startswith(">>> ")]
    assert stages == [ln for ln in jax_lines if ln.startswith(">>> ")]
    assert all(os.path.exists(p) for p in both_runs["result"].output_files)


STREAM_ARGS = dict(ARGS, train_mode="streaming", shard_paths=24,
                   stream_patience=4)


def test_device_walker_backend_writes_the_native_files(both_runs):
    """``walker_backend="device"`` (the walker kernel's plain version on
    the CPU) writes byte-identical files and the same stage-3 rows."""
    native = both_runs["result"]
    assert native.walker_backend == "native"
    cfg = G2VecConfig(expression_file=both_runs["files"]["expression"],
                      clinical_file=both_runs["files"]["clinical"],
                      network_file=both_runs["files"]["network"],
                      result_name=str(both_runs["tmp"] / "port_device"),
                      compute_dtype="float32", device="cpu",
                      walker_backend="device", **ARGS)
    result = run(cfg, console=lambda s: None, init=both_runs["init"],
                 kmeans_centers0=both_runs["centers0"])
    assert result.walker_backend == "device" and result.sampler_threads == 0
    np.testing.assert_array_equal(result.paths, native.paths)
    for got, want in zip(result.output_files, native.output_files):
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()


@pytest.fixture(scope="module")
def streaming_runs(both_runs):
    files, tmp = both_runs["files"], both_runs["tmp"]
    data, src, dst = _jax_inputs(files)
    n_genes, hidden = len(data.gene), ARGS["sizeHiddenlayer"]
    groups = [tuple(np.asarray(a) for a in jgraph.thresholded_edges(
        data.expr[data.label == i], src, dst, 0.5)) for i in range(2)]
    ref = jax_stream(groups=groups, n_genes=n_genes, genes=data.gene,
                     hidden=hidden, learning_rate=0.005,
                     max_epochs=ARGS["epoch"], compute_dtype="float32",
                     seed=ARGS["seed"], walk_seed=ARGS["seed"],
                     len_path=ARGS["lenPath"], reps=ARGS["numRepetition"],
                     shard_paths=STREAM_ARGS["shard_paths"],
                     patience=STREAM_ARGS["stream_patience"],
                     use_pallas=False, console=lambda s: None)
    p = jax_init_params(jax.random.key(ARGS["seed"]), n_genes, hidden)
    centers0 = both_runs["centers0"]
    jax_files = _jax_stages_5_to_7(data, ref.train.w_ih, ref.gene_freq,
                                   centers0, str(tmp / "jax_stream"))
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp / "port_stream"),
                      compute_dtype="float32", device="cpu", **STREAM_ARGS)
    result = run(cfg, console=lambda s: None,
                 init=(np.asarray(p.w_ih), np.asarray(p.w_ho)),
                 kmeans_centers0=centers0)
    return dict(ref=ref, jax_files=jax_files, result=result)


def test_streaming_training_matches_the_jax_composition(streaming_runs):
    ref, result = streaming_runs["ref"], streaming_runs["result"]
    assert len(ref.train.history) >= 3
    assert result.n_paths == ref.n_paths
    assert result.n_path_genes == len(ref.gene_freq)
    assert result.stop_epoch == ref.train.stop_epoch
    assert [(h["acc_val"], h["acc_tr"]) for h in result.train_history] == \
        [(h["acc_val"], h["acc_tr"]) for h in ref.train.history]
    np.testing.assert_allclose(result.embeddings, ref.train.w_ih, rtol=1e-5,
                               atol=1e-7)
    assert result.paths is None
    assert result.stream_stats["n_paths"] == ref.n_paths


@pytest.mark.parametrize("suffix", ["biomarkers", "lgroups"])
def test_streaming_selection_files_are_byte_equal(streaming_runs, suffix):
    port = streaming_runs["result"].output_files[SUFFIXES.index(suffix)]
    ref = streaming_runs["jax_files"][SUFFIXES.index(suffix)]
    with open(port, "rb") as a, open(ref, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    if suffix == "lgroups":
        groups = {line.split("\t")[1] for line in got.decode().splitlines()[1:]}
        assert groups == {"0", "1", "2"}
