"""The frozen roofline arithmetic reproduces the bounds PERF.md §6
records for the port's kernels."""
import numpy as np
import pytest

import pbtest  # noqa: F401 (puts the benchmark on sys.path)

pytestmark = pytest.mark.torch


def test_packed_forward_and_backward_bounds():
    import roofline

    fwd = roofline.bound_s(*roofline.fwd_work(40399, 5850, 128, 0))
    bwd = roofline.bound_s(*roofline.bwd_work(32319, 5850, 128, 0))
    assert round(fwd * 1e3, 4) == 0.0154
    assert round(bwd * 1e3, 4) == 0.0104
    # Adds bound a launch only where set bits x H outrun the bytes.
    nbytes, adds = roofline.fwd_work(100, 5850, 128, 10 ** 9)
    assert roofline.bound_s(nbytes, adds) == adds / roofline.F32_ADDS_PER_S


def test_walker_bytes_at_the_synthetic_example():
    """PERF.md §6: 43,650,820 bytes for one group's walk at the port's
    synthetic example (G 5,850, 58,500 walkers), its CSR as the
    reference thresholds it."""
    import roofline
    from g2vec_tpu_torch.data.synthetic import SCALES, make_synthetic
    from reference import plain

    expr, clin, net, _ = make_synthetic(SCALES["example"])
    names = sorted(set(expr.gene) | net.genes)
    idx = {g: i for i, g in enumerate(names)}
    graph = plain.common_graph(
        np.array(names), list(expr.sample),
        np.array([clin[s] for s in expr.sample]),
        np.array([idx[g] for g in expr.gene]),
        expr.expr.T.astype(np.float64),
        np.array([idx[a] for a, _ in net.edges]),
        np.array([idx[b] for _, b in net.edges]))
    _, indices, _ = plain.group_csr(graph, 0, 0.5)
    assert roofline.walk_bytes(5850, indices.size, 58500) == 43650820


def test_states_bytes_and_dense_flops():
    import roofline

    assert roofline.states_bytes([1, 2], [3, 2], 100, 10) == (
        16 * 2 + 4 * 3 + 4 * 2 + 17 * 2 + 100 + 10)
    assert roofline.dense_flops(10, 20, 4, False) == 2 * 10 * 20 * 4 + 80
    assert roofline.set_bits(np.array([[255, 1]], np.uint8)) == 9
