"""Stage 3 of the port against the JAX package: edges, walks, path sets.

- thresholded edge SETS are equal and their |PCC| weights agree at 1e-6
  (float32 sums in a different order) on the golden spec and on
  make_example's ``medium`` spec;
- the port's copy of the C++ walker emits byte-identical packed rows for
  the same edges and seed, at any thread count;
- integrate_path_sets and count_gene_freq give equal results.
"""
import numpy as np
import pytest

from g2vec_tpu.data.make_example import SCALES
from g2vec_tpu.data.synthetic import SyntheticSpec, make_synthetic
from g2vec_tpu.ops import graph as jgraph
from g2vec_tpu.ops import host_walker as jwalker
from g2vec_tpu.ops import walker as jpaths
from g2vec_tpu.preprocess import (edges_to_indices, find_common_genes,
                                  make_gene2idx, match_labels, restrict_data,
                                  restrict_network)
from g2vec_tpu_torch.ops import graph as tgraph
from g2vec_tpu_torch.ops import host_walker as twalker
from g2vec_tpu_torch.ops import paths as tpaths

pytestmark = pytest.mark.torch

GOLDEN = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                       n_expr_only=4, n_net_only=4, module_chords=2,
                       background_edges=40, seed=7)
SPECS = {"golden": GOLDEN, "medium": SCALES["medium"]}


def _stage2(spec):
    expr, clinical, network, _ = make_synthetic(spec)
    expr.label = match_labels(clinical, expr.sample)
    common = find_common_genes(network.genes, expr.gene)
    network = restrict_network(network, common)
    expr = restrict_data(expr, common)
    src, dst = edges_to_indices(network, make_gene2idx(expr.gene))
    return expr, src, dst


@pytest.fixture(scope="module", params=sorted(SPECS))
def stage2(request):
    return request.param, _stage2(SPECS[request.param])


@pytest.mark.parametrize("group", [0, 1])
def test_thresholded_edges_match_jax(stage2, group):
    _, (expr, src, dst) = stage2
    expr_group = expr.expr[expr.label == group]
    w_jax = np.asarray(jgraph.edge_weights(expr_group, src, dst))
    w_port = tgraph.edge_weights(expr_group, src, dst, device="cpu").numpy()
    np.testing.assert_allclose(w_port, w_jax, rtol=0, atol=1e-6)
    s_j, d_j, ww_j = jgraph.thresholded_edges(expr_group, src, dst, 0.5)
    s_t, d_t, ww_t = tgraph.thresholded_edges(expr_group, src, dst, 0.5,
                                              device="cpu")
    assert len(s_j) > 0
    assert np.array_equal(s_t, s_j) and np.array_equal(d_t, d_j)
    np.testing.assert_allclose(ww_t, ww_j, rtol=0, atol=1e-6)


def test_zscore_degenerate_columns_are_zero_as_in_jax(rng):
    import torch

    # Column 0 is constant at a value whose float32 std is not exactly 0;
    # column 2 is constant at an exactly representable value.
    expr = rng.standard_normal((30, 4)).astype(np.float32)
    expr[:, 0] = 0.1
    expr[:, 2] = 5.0
    z_t = tgraph._zscore_columns(torch.from_numpy(expr)).numpy()
    z_j = np.asarray(jgraph._zscore_columns(expr))
    assert not z_t[:, [0, 2]].any() and not z_j[:, [0, 2]].any()
    np.testing.assert_allclose(z_t, z_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("len_path,reps,seed,threads", [
    (20, 3, 22, 1), (20, 3, 23, 4), (80, 2, 0, 0)])
def test_walker_rows_byte_identical(stage2, len_path, reps, seed, threads):
    _, (expr, src, dst) = stage2
    n_genes = expr.expr.shape[1]
    edges = jgraph.thresholded_edges(expr.expr[expr.label == seed % 2],
                                     src, dst, 0.5)
    rows_j = jwalker.walk_packed_rows(*edges, n_genes, len_path=len_path,
                                      reps=reps, seed=seed, n_threads=threads)
    rows_t = twalker.walk_packed_rows(*edges, n_genes, len_path=len_path,
                                      reps=reps, seed=seed, n_threads=threads)
    assert rows_t.dtype == np.uint8 and rows_t.shape == rows_j.shape
    assert np.array_equal(rows_t, rows_j)
    assert twalker.generate_path_set_native(
        *edges, n_genes, len_path=len_path, reps=reps, seed=seed) == \
        jwalker.generate_path_set_native(
            *edges, n_genes, len_path=len_path, reps=reps, seed=seed)


def test_integrate_and_gene_freq_match_jax(stage2):
    _, (expr, src, dst) = stage2
    n_genes = expr.expr.shape[1]
    sets = []
    for i in range(2):
        edges = jgraph.thresholded_edges(expr.expr[expr.label == i], src,
                                         dst, 0.5)
        sets.append(jwalker.generate_path_set_native(
            *edges, n_genes, len_path=20, reps=3, seed=(5 << 1) | i))
    p_j, l_j = jpaths.integrate_path_sets(sets[0], sets[1], n_genes,
                                          packed=True)
    p_t, l_t = tpaths.integrate_path_sets(sets[0], sets[1], n_genes)
    assert np.array_equal(p_t, p_j) and np.array_equal(l_t, l_j)
    assert tpaths.count_gene_freq(p_t, l_t, expr.gene) == \
        jpaths.count_gene_freq(p_j, l_j, expr.gene, packed=True)


def test_walker_rejects_out_of_range_ids():
    src = np.array([0, 1], np.int32)
    with pytest.raises(ValueError, match="outside"):
        twalker.walk_packed_rows(src, np.array([1, 5], np.int32),
                                 np.ones(2, np.float32), 3, len_path=4,
                                 reps=1, seed=0)
