"""The port's query plane against the JAX package's, on the same inputs.

- ``ops/knn.py`` and ``ops/ann.py``: the port's copies give the JAX
  package's answers exactly, indices and values, on seeded numpy tables
  (integer-valued ones with forced ties and a zero row, and real-valued
  ones), and both equal a numpy full stable sort (ties by ascending
  index); the seeded IVF build gives the same bytes.
- ``io/writers.write_inventory_bundle``: for the same arrays every array
  file of the port's bundle is byte-identical to the JAX package's, and
  ``meta.json`` is equal except ``ann.build_ms`` (a wall time).
- Each package's ``InventoryCatalog`` opens the other's bundle and both
  give the same ``run_query``/``run_fquery`` answers.
- The solo ``--emit-inventory --ann-nlist 4`` run on the CPU, with the
  injected CBOW init and k-means centres of tests/test_torch_pipeline.py,
  publishes a bundle whose ``[2, G]`` scores match the JAX stage
  composition's at that file's tolerances (rtol 1e-5, atol 1e-6), whose
  table equals its own ``_vectors.txt`` through ``read_vectors_txt``, and
  whose metrics stream holds the ``inventory`` and ``ann_build`` events.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from g2vec_tpu import analysis as janalysis
from g2vec_tpu import preprocess as jprep
from g2vec_tpu.io import readers as jreaders
from g2vec_tpu.io import writers as jwriters
from g2vec_tpu.ops import ann as jann
from g2vec_tpu.ops import graph as jgraph
from g2vec_tpu.ops import host_walker as jwalker
from g2vec_tpu.ops import kmeans as jkmeans
from g2vec_tpu.ops import knn as jknn
from g2vec_tpu.ops import walker as jpaths
from g2vec_tpu.serve import inventory as jinventory
from g2vec_tpu.train.trainer import train_cbow as jax_train
from g2vec_tpu_torch.config import G2VecConfig, config_from_args
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.io import writers
from g2vec_tpu_torch.ops import ann, knn
from g2vec_tpu_torch.pipeline import run
from g2vec_tpu_torch.resilience import faults
from g2vec_tpu_torch.serve import inventory

pytestmark = pytest.mark.torch


def _int_embeddings(g=257, h=8, seed=0):
    """Integer-valued f32 rows: every dot product is exact in any order,
    so a full sort and the blocked kernels must agree bitwise; a zero
    row and duplicated rows force ties."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-5, 6, size=(g, h)).astype(np.float32)
    emb[7] = 0.0
    emb[100] = emb[3]
    emb[101] = emb[3]
    return emb


def _real_embeddings(g=300, h=16, seed=1):
    return np.random.default_rng(seed).standard_normal((g, h)).astype(
        np.float32)


def _full_sort(emb, q, k, exclude=-1):
    """One matmul and one stable descending sort (ties by ascending
    index), with the query plane's zero-norm guard."""
    g = emb.shape[0]
    sims = emb @ q
    norms = np.sqrt((emb * emb).sum(axis=1))
    denom = norms * np.float32(np.sqrt(np.dot(q, q)))
    ok = denom > 0
    sims = np.where(ok, sims / np.where(ok, denom, 1), np.float32(-2.0))
    if 0 <= exclude < g:
        sims[exclude] = -np.inf
    order = np.lexsort((np.arange(g), -sims))[:min(k, g)]
    return order, sims[order]


# ---------------------------------------------------------------------------
# ops/knn.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 50, 257, 400])
@pytest.mark.parametrize("block_rows", [1, 13, 8192])
def test_cosine_topk_equals_jax_and_the_full_sort(k, block_rows):
    emb = _int_embeddings()
    norms = knn.row_norms(emb, block_rows=block_rows)
    np.testing.assert_array_equal(norms, jknn.row_norms(emb,
                                                        block_rows=block_rows))
    for exclude in (-1, 3, 7):
        for qi in (3, 7, 42):
            q = emb[qi]
            idx, sims = knn.cosine_topk(emb, norms, q, k, exclude=exclude,
                                        block_rows=block_rows)
            jidx, jsims = jknn.cosine_topk(emb, norms, q, k, exclude=exclude,
                                           block_rows=block_rows)
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(sims, jsims)
            nidx, nsims = _full_sort(emb, q, k, exclude)
            np.testing.assert_array_equal(idx, nidx)
            np.testing.assert_array_equal(sims, nsims)


def test_cosine_topk_subset_and_topk_scores_equal_jax():
    emb = _real_embeddings()
    norms = knn.row_norms(emb)
    rng = np.random.default_rng(2)
    rows = np.sort(rng.choice(emb.shape[0], size=120, replace=False))
    for k in (1, 10, 120, 200):
        got = knn.cosine_topk_subset(emb, norms, rows, emb[rows[5]], k,
                                     exclude=int(rows[5]), block_rows=7)
        want = jknn.cosine_topk_subset(emb, norms, rows, emb[rows[5]], k,
                                       exclude=int(rows[5]), block_rows=7)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    scores = rng.integers(-3, 4, size=500).astype(np.float32)   # many ties
    for k in (1, 7, 500, 600):
        idx, sc = knn.topk_scores(scores, k)
        jidx, jsc = jknn.topk_scores(scores, k)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(sc, jsc)
        order = np.lexsort((np.arange(500), -scores))[:k]
        np.testing.assert_array_equal(idx, order)


# ---------------------------------------------------------------------------
# ops/ann.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,ann_nlist", [
    (0, 0), (10, 0), (4095, 0), (4096, 0), (9000, 0), (50, 8), (5, 64),
    (5000, -1)])
def test_resolve_nlist_equals_jax(n_rows, ann_nlist):
    assert ann.resolve_nlist(n_rows, ann_nlist) == \
        jann.resolve_nlist(n_rows, ann_nlist)


@pytest.mark.parametrize("seeded", [False, True])
def test_ivf_build_and_probe_equal_jax(seeded):
    emb = _real_embeddings(g=600, h=16, seed=3)
    seeds = (np.random.default_rng(4).standard_normal((12, 16))
             .astype(np.float32) if seeded else None)
    built = ann.build_ivf(emb, 12, seed_centroids=seeds)
    want = jann.build_ivf(emb, 12, seed_centroids=seeds)
    for a, b in zip(built, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assign = np.random.default_rng(5).integers(0, 12, size=600)
    assign[assign == 3] = 4                           # an empty cluster
    np.testing.assert_array_equal(
        ann.lloyd_update(emb, built[0], assign),
        jann.lloyd_update(emb, built[0], assign))
    cent, post, off = built
    norms = knn.row_norms(emb)
    index = ann.IVFIndex(cent, post, off, 600, 16,
                         pvecs=np.ascontiguousarray(emb[post]))
    jindex = jann.IVFIndex(cent, post, off, 600, 16,
                           pvecs=np.ascontiguousarray(emb[post]))
    for qi, k, nprobe in ((0, 10, 1), (17, 5, 3), (599, 50, 12),
                          (300, 600, 4)):
        for posting_major in (False, True):
            got = ann.ivf_topk(emb, norms, index, emb[qi], k, nprobe=nprobe,
                               exclude=qi, posting_major=posting_major)
            ref = jann.ivf_topk(emb, norms, jindex, emb[qi], k,
                                nprobe=nprobe, exclude=qi,
                                posting_major=posting_major)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        if nprobe >= 12:                         # every list: the exact path
            idx, sims, _ = ann.ivf_topk(emb, norms, index, emb[qi], k,
                                        nprobe=nprobe, exclude=qi)
            eidx, esims = knn.cosine_topk(emb, norms, emb[qi], k, exclude=qi)
            np.testing.assert_array_equal(idx, eidx)
            np.testing.assert_array_equal(sims, esims)


# ---------------------------------------------------------------------------
# io/writers.write_inventory_bundle and serve/inventory.py
# ---------------------------------------------------------------------------

def _arrays(g=80, h=8, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((g, h)).astype(np.float32)
    genes = [f"G{i:03d}" for i in range(g)]
    scores = rng.standard_normal((2, g)).astype(np.float32)
    centers = rng.standard_normal((3, h)).astype(np.float32)
    return emb, genes, scores, centers


def _gen_dir(root):
    return os.path.join(root, writers.read_generation(root))


@pytest.mark.parametrize("ann_nlist,with_scores,seeded", [
    (0, True, False), (4, True, True), (5, False, False), (-1, True, True)])
def test_bundle_files_equal_jax(tmp_path, ann_nlist, with_scores, seeded):
    emb, genes, scores, centers = _arrays()
    kw = dict(ann_nlist=ann_nlist,
              seed_centroids=centers if seeded else None)
    meta = {"source": "test", "job_id": "j1"}
    port = str(tmp_path / "port")
    ref = str(tmp_path / "ref")
    writers.write_inventory_bundle(port, emb, genes,
                                   scores if with_scores else None, meta, **kw)
    jwriters.write_inventory_bundle(ref, emb, genes,
                                    scores if with_scores else None, meta,
                                    **kw)
    pg, rg = _gen_dir(port), _gen_dir(ref)
    assert os.path.basename(pg) == os.path.basename(rg) == "gen-000001"
    assert sorted(os.listdir(pg)) == sorted(os.listdir(rg))
    assert (writers.INVENTORY_ARRAYS, writers.INVENTORY_MANIFEST,
            writers.GENERATION_FILE, writers.ANN_SCORE_TOPM) == \
        (jwriters.INVENTORY_ARRAYS, jwriters.INVENTORY_MANIFEST,
         jwriters.GENERATION_FILE, jwriters.ANN_SCORE_TOPM)
    for name in os.listdir(pg):
        if name in ("meta.json", writers.INVENTORY_MANIFEST):
            continue
        with open(os.path.join(pg, name), "rb") as a, \
                open(os.path.join(rg, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(pg, "meta.json")) as a, \
            open(os.path.join(rg, "meta.json")) as b:
        got, want = json.load(a), json.load(b)
    for m in (got, want):
        if m["ann"]:
            m["ann"].pop("build_ms")
    assert got == want
    assert (got["ann"] is not None) == bool(ann.resolve_nlist(80, ann_nlist))


def test_republish_keeps_two_generations(tmp_path):
    emb, genes, scores, _ = _arrays()
    root = str(tmp_path / "b")
    for i in range(3):
        writers.write_inventory_bundle(root, emb + i, genes, scores, {})
    assert writers.read_generation(root) == "gen-000003"
    assert sorted(os.listdir(root)) == ["GENERATION", "gen-000002",
                                        "gen-000003"]


@pytest.fixture(scope="module")
def two_bundles(tmp_path_factory):
    """One bundle written by each package under one root, from different
    arrays over overlapping genes."""
    root = str(tmp_path_factory.mktemp("inv"))
    a = _arrays(g=90, h=8, seed=10)
    b = _arrays(g=90, h=8, seed=11)
    writers.write_inventory_bundle(os.path.join(root, "jp", "v"), a[0], a[1],
                                   a[2], {"source": "port"}, ann_nlist=6,
                                   seed_centroids=a[3])
    jwriters.write_inventory_bundle(os.path.join(root, "jj", "v"), b[0],
                                    b[1], b[2], {"source": "jax"},
                                    ann_nlist=6)
    return root


def test_each_catalog_opens_the_others_bundle(two_bundles):
    cat = inventory.InventoryCatalog([two_bundles], 1 << 26)
    jcat = jinventory.InventoryCatalog([two_bundles], 1 << 26)
    assert inventory.scan_bundles([two_bundles]) == \
        jinventory.scan_bundles([two_bundles])
    assert cat.listing() == jcat.listing()
    for key in ("jp/v", "jj/v"):
        for q, kw in (("neighbors", dict(gene="G004", k=7, mode="exact")),
                      ("neighbors", dict(gene="G004", k=7, nprobe=2)),
                      ("neighbors", dict(gene="G050", k=90, nprobe=6)),
                      ("topk_biomarkers", dict(k=5)),
                      ("topk_biomarkers", dict(k=5, mode="exact")),
                      ("meta", {})):
            got = inventory.run_query(cat, q, key, **kw)
            want = jinventory.run_query(jcat, q, key, **kw)
            got.pop("mapped_bytes", None)
            want.pop("mapped_bytes", None)
            assert got == want, (key, q, kw)
    for fq, kw in (("gene_rank", dict(k=10)),
                   ("bundle_overlap", dict(k=10, ref_genes=["G001", "G002",
                                                            "G003"]))):
        got = inventory.run_fquery(cat, fq, "G004", **kw)
        want = jinventory.run_fquery(jcat, fq, "G004", **kw)
        assert got == want
        assert inventory.merge_fquery(fq, got) == \
            jinventory.merge_fquery(fq, want)


def test_tampered_bundle_is_refused_and_a_torn_index_falls_back(
        two_bundles, tmp_path):
    import shutil

    root = str(tmp_path / "copy")
    shutil.copytree(two_bundles, root)
    gen = _gen_dir(os.path.join(root, "jj", "v"))
    with open(os.path.join(gen, "embeddings.npy"), "r+b") as f:
        f.seek(200)
        f.write(b"\x00\x01\x02\x03")
    cat = inventory.InventoryCatalog([root], 1 << 26)
    with pytest.raises(inventory.InventoryError) as e:
        inventory.run_query(cat, "neighbors", "jj/v", gene="G004", k=3)
    assert e.value.code == "tampered"
    gen = _gen_dir(os.path.join(root, "jp", "v"))
    with open(os.path.join(gen, "ann_postings.npy"), "r+b") as f:
        f.seek(140)
        f.write(b"\x07\x07")
    cat = inventory.InventoryCatalog([root], 1 << 26)
    got = inventory.run_query(cat, "neighbors", "jp/v", gene="G004", k=5)
    assert got["recall_mode"] == "exact_fallback"
    exact = inventory.run_query(cat, "neighbors", "jp/v", gene="G004", k=5,
                                mode="exact")
    assert got["neighbors"] == exact["neighbors"]


def test_ann_build_seam_tears_the_index(tmp_path, monkeypatch):
    """The ``ann_build`` seam's corrupt kind publishes an index whose bytes
    fail their manifest: queries fall back to the exact scan."""
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    emb, genes, scores, _ = _arrays()
    faults.install_plan("stage=ann_build,kind=corrupt")
    try:
        writers.write_inventory_bundle(str(tmp_path / "b"), emb, genes,
                                       scores, {}, ann_nlist=4)
    finally:
        faults._reset_for_tests()
    cat = inventory.InventoryCatalog([str(tmp_path)], 1 << 26)
    got = inventory.run_query(cat, "neighbors", "b", gene="G001", k=4)
    assert got["recall_mode"] == "exact_fallback"
    assert got["ann_warning"]["code"] == "tampered"


def test_read_vectors_txt_equals_jax(tmp_path):
    emb, genes, _, _ = _arrays(g=20, h=5)
    path = writers.write_vectors(str(tmp_path / "r"), emb, genes)
    got, want = inventory.read_vectors_txt(path), \
        jinventory.read_vectors_txt(path)
    assert got[0] == want[0] == genes
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The solo run's --emit-inventory
# ---------------------------------------------------------------------------

SPEC = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                     n_expr_only=4, n_net_only=4, module_chords=2,
                     background_edges=40, seed=7)
ARGS = dict(lenPath=20, numRepetition=3, sizeHiddenlayer=16, epoch=30,
            numBiomarker=10, seed=11)


def _jax_scores(files, init, centers0):
    """Stages 1-6 from the JAX package's stage functions with the
    injected init and k-means starting centres (the composition of
    tests/test_torch_pipeline.py): the ``[2, G]`` scores and the winning
    centres."""
    data = jreaders.load_expression(files["expression"])
    data.label = jprep.match_labels(jreaders.load_clinical(files["clinical"]),
                                    data.sample)
    network = jreaders.load_network(files["network"])
    common = jprep.find_common_genes(network.genes, data.gene)
    network = jprep.restrict_network(network, common)
    data = jprep.restrict_data(data, common)
    src, dst = jprep.edges_to_indices(network, jprep.make_gene2idx(data.gene))
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
    emb = jnp.asarray(trained.w_ih)
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
    return scores2, np.asarray(best)


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("emit")
    files = write_synthetic_tsv(SPEC, str(tmp))
    n_common = len(jprep.find_common_genes(
        jreaders.load_network(files["network"]).genes,
        jreaders.load_expression(files["expression"]).gene))
    rng = np.random.default_rng(5)
    hidden = ARGS["sizeHiddenlayer"]
    init = ((np.clip(rng.standard_normal((n_common, hidden)), -2, 2)
             / np.sqrt(hidden)).astype(np.float32),
            (np.clip(rng.standard_normal((hidden, 1)), -2, 2)
             / np.sqrt(hidden)).astype(np.float32))
    centers0 = init[0][rng.choice(n_common, size=(10, 3), replace=True)]
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp / "port"), compute_dtype="float32",
                      device="cpu", emit_inventory=True, ann_nlist=4,
                      metrics_jsonl=str(tmp / "m.jsonl"), **ARGS)
    lines = []
    result = run(cfg, console=lines.append, init=init,
                 kmeans_centers0=centers0)
    return dict(tmp=tmp, result=result, lines=lines,
                jax=_jax_scores(files, init, centers0))


def test_emit_inventory_scores_match_the_jax_composition(emitted):
    result = emitted["result"]
    scores2, centers = emitted["jax"]
    np.testing.assert_allclose(result.biomarker_scores, scores2, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(result.km_centers, centers, rtol=1e-5,
                               atol=1e-6)
    gen = _gen_dir(str(emitted["tmp"] / "port_inventory"))
    np.testing.assert_array_equal(np.load(os.path.join(gen, "scores.npy")),
                                  result.biomarker_scores)
    np.testing.assert_allclose(np.load(os.path.join(gen, "scores.npy")),
                               scores2, rtol=1e-5, atol=1e-6)
    assert any(line.strip() == gen for line in emitted["lines"])


def test_emit_inventory_table_equals_its_vectors_file(emitted):
    result = emitted["result"]
    root = str(emitted["tmp"] / "port_inventory")
    genes, table = inventory.read_vectors_txt(result.output_files[2])
    cat = inventory.InventoryCatalog([str(emitted["tmp"])], 1 << 26)
    b = cat.get("port_inventory")
    assert list(b.genes) == genes == list(result.genes)
    # The text prints six decimals (half a unit of the last one, plus the
    # float32 rounding of the parse): the table is the float32 embedding.
    np.testing.assert_allclose(np.asarray(b.embeddings), table, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(b.embeddings),
                                  result.embeddings)
    with open(os.path.join(_gen_dir(root), "meta.json")) as f:
        meta = json.load(f)
    assert meta["source"] == "solo" and meta["result_name"] == "port"
    assert meta["ann"]["nlist"] == 4 and meta["ann"]["seeded"] is True
    # The JAX package's catalog reads the port's solo bundle too.
    jcat = jinventory.InventoryCatalog([str(emitted["tmp"])], 1 << 26)
    assert jinventory.run_query(jcat, "topk_biomarkers", "port_inventory",
                                k=5) == inventory.run_query(
        cat, "topk_biomarkers", "port_inventory", k=5)


def test_emit_inventory_metrics_events(emitted):
    with open(emitted["tmp"] / "m.jsonl") as f:
        records = [json.loads(line) for line in f]
    inv = [r for r in records if r["event"] == "inventory"]
    built = [r for r in records if r["event"] == "ann_build"]
    assert len(inv) == 1 and inv[0]["outcome"] == "published" \
        and inv[0]["bundle"] == "port_inventory" and inv[0]["bytes"] > 0
    assert len(built) == 1 and built[0]["nlist"] == 4 \
        and built[0]["outcome"] == "built" and built[0]["seeded"] is True


def test_emit_inventory_flags_parse():
    cfg = config_from_args(["e", "c", "n", "r", "--emit-inventory",
                            "--ann-nlist", "-1"])
    assert cfg.emit_inventory and cfg.ann_nlist == -1
    cfg = config_from_args(["e", "c", "n", "r"])
    assert not cfg.emit_inventory and cfg.ann_nlist == 0
