"""Stages 5-6 of the port against the JAX package.

- tscores, minmax, masked_minmax and dscores agree at rtol 1e-6 (float32,
  different sum orders);
- Lloyd from the same injected ``centers0`` gives the same assignments as
  the JAX ``_lloyd``;
- L-groups and the biomarker list are equal for the same embeddings and
  the same starting centres.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vec_tpu import analysis as janalysis
from g2vec_tpu.ops import kmeans as jkmeans
from g2vec_tpu.ops import stats as jstats
from g2vec_tpu_torch import analysis as tanalysis
from g2vec_tpu_torch.ops import kmeans as tkmeans
from g2vec_tpu_torch.ops import stats as tstats

pytestmark = pytest.mark.torch


def _blobs(rng, n=300, d=16, k=3):
    centers = rng.standard_normal((k, d)) * 3.0
    member = rng.integers(0, k, size=n)
    x = centers[member] + rng.standard_normal((n, d)) * 0.8
    return x.astype(np.float32)


def test_stats_match_jax(rng):
    good = rng.standard_normal((20, 50)).astype(np.float32)
    poor = (rng.standard_normal((15, 50)) + 0.5).astype(np.float32)
    good[:, 3] = 1.0
    poor[:, 3] = 1.0                       # constant gene: t = 0
    t = tstats.tscores(torch.tensor(good), torch.tensor(poor)).numpy()
    np.testing.assert_allclose(t, np.asarray(jstats.tscores(good, poor)),
                               rtol=1e-6, atol=1e-6)
    assert t[3] == 0.0
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tstats.dscores(torch.tensor(emb)).numpy(),
        np.asarray(jstats.dscores(emb)), rtol=1e-6)
    mask = rng.random(50) < 0.4
    for m in (mask, np.zeros(50, bool)):
        np.testing.assert_allclose(
            tstats.masked_minmax(torch.tensor(t), torch.tensor(m)).numpy(),
            np.asarray(jstats.masked_minmax(t, m)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tstats.minmax(torch.tensor(t)).numpy(),
                               np.asarray(jstats.minmax(t)), rtol=1e-6,
                               atol=1e-7)


def test_lloyd_assignments_match_jax(rng):
    x = _blobs(rng)
    c0 = x[rng.choice(len(x), size=(10, 3))]
    # Duplicate starting centres exercise the argmin tie to the lowest
    # index; a centre far from every point stays empty and frozen.
    c0[1, 2] = c0[1, 1]
    c0[0, 2] = 100.0
    c_j, i_j = jax.vmap(lambda c: jkmeans._lloyd(jnp.asarray(x), c, 50))(
        jnp.asarray(c0))
    c_t, i_t = tkmeans._lloyd(torch.tensor(x), torch.tensor(c0), 50)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(i_t.numpy(), np.asarray(i_j), rtol=1e-5)
    for r in range(10):
        a_j = np.asarray(jnp.argmin(jkmeans._pairwise_sq_dists(
            jnp.asarray(x), c_j[r]), axis=1))
        a_t = torch.argmin(tkmeans._pairwise_sq_dists(
            torch.tensor(x), c_t[r]), dim=1).numpy()
        assert np.array_equal(a_t, a_j)
    np.testing.assert_array_equal(c_t[0, 2].numpy(), c0[0, 2])


@pytest.mark.parametrize("compat", [False, True])
def test_lgroups_and_biomarkers_match_jax(rng, compat):
    n_genes, hidden = 240, 16
    emb = _blobs(rng, n=n_genes, d=hidden)
    freq = rng.integers(0, 3, size=n_genes).astype(np.int32)
    c0 = emb[rng.choice(n_genes, size=(10, 3))]
    genes = np.array([f"G{i:04d}" for i in range(n_genes)])
    expr = rng.standard_normal((30, n_genes)).astype(np.float32)
    labels = (np.arange(30) % 2).astype(np.int32)

    # JAX composition: vmapped Lloyd over the same starts, best inertia,
    # the vote, the renumbering, then stage 6.
    x = jnp.asarray(emb)
    c_j, i_j = jax.vmap(lambda c: jkmeans._lloyd(x, c, 300))(jnp.asarray(c0))
    best = int(jnp.argmin(i_j))
    km = jnp.argmin(jkmeans._pairwise_sq_dists(x, c_j[best]), axis=1)
    counts, good, poor = janalysis._vote_counts(km, jnp.asarray(freq), 3)
    gc, pc = janalysis._pick_clusters(np.asarray(counts), np.asarray(good),
                                      np.asarray(poor), 3, compat)
    lg_j = np.asarray(janalysis._renumber(km, gc, pc))
    s_j = np.asarray(janalysis.biomarker_scores_device(
        emb, expr[labels == 0], expr[labels == 1], lg_j, 0.5))
    bm_j, _ = janalysis.top_biomarkers(s_j, lg_j, genes, 12)

    lg_t, _ = tanalysis.find_lgroups(
        torch.tensor(emb), freq, generator=torch.Generator().manual_seed(0),
        iters=300, compat_tiebreak=compat, centers0=c0)
    lg_t = lg_t.numpy()
    s_t = tanalysis.biomarker_scores(
        torch.tensor(emb), torch.tensor(expr[labels == 0]),
        torch.tensor(expr[labels == 1]), torch.tensor(lg_t), 0.5).numpy()
    bm_t, _ = tanalysis.top_biomarkers(s_t, lg_t, genes, 12)
    assert np.array_equal(lg_t, lg_j)
    assert set(np.unique(lg_t)) == {0, 1, 2}
    assert bm_t == bm_j
    for group in (0, 1):
        m = lg_t == group
        np.testing.assert_allclose(s_t[group][m], s_j[group][m], rtol=1e-5,
                                   atol=1e-6)


def test_pick_clusters_matches_jax(rng):
    for _ in range(50):
        counts, good, poor = (rng.integers(0, 5, size=4) for _ in range(3))
        for compat in (False, True):
            assert tanalysis._pick_clusters(counts, good, poor, 4, compat) == \
                janalysis._pick_clusters(counts, good, poor, 4, compat)
    genes = ["A", "B"]
    assert tanalysis.freq_index(genes, {"B": 1}).tolist() == [2, 1]


def test_kmeanspp_is_seeded_and_device_independent(rng):
    x = torch.tensor(_blobs(rng))
    a = tkmeans.kmeans(x, 3, generator=torch.Generator().manual_seed(7),
                       n_init=4, iters=20)
    b = tkmeans.kmeans(x, 3, generator=torch.Generator().manual_seed(7),
                       n_init=4, iters=20)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert sorted(torch.bincount(a[0], minlength=3).tolist())[0] > 0
    with pytest.raises(ValueError, match="centers0"):
        tkmeans.kmeans(x, 3, generator=torch.Generator(),
                       centers0=np.zeros((2, 4, 16), np.float32))
