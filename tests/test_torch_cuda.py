"""The port's Hopper kernels on the card (skipped where torch sees no GPU).

Run on a machine with an H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX, which this
file neither needs nor imports.) Each kernel is held against its plain
PyTorch version on the same card tensors. Both take f32 sums of the same
bf16 values in different orders, so an element may differ by a few f32
rounding steps of its sum of absolute terms S:
``|kernel - plain| <= 1e-5 * |plain| + 256 * 2^-24 * S``. One term
dropped or added moves an element by about S / n_terms, far above that.
"""
import numpy as np
import pytest
import torch

from g2vec_tpu_torch.ops import packed_matmul as pm

pytestmark = pytest.mark.torch

RTOL, ULPS = 1e-5, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, g, h, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((m, g)) < density
    packed = torch.from_numpy(np.packbits(x, axis=1)).cuda()
    w = torch.from_numpy(rng.standard_normal((g, h)).astype(np.float32)
                         * 0.1).cuda()
    g_out = torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32)
                             ).cuda()
    return torch.from_numpy(x.astype(np.float32)).cuda(), packed, w, g_out


def _assert_close(got, want, abs_sum):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    tol = RTOL * want.abs() + ULPS * 2.0 ** -24 * abs_sum
    assert int(((got - want).abs() > tol).sum()) == 0


@pytest.mark.parametrize("m,g,h,density", [
    (512, 1024, 128, 0.05), (1001, 1003, 132, 0.02), (3, 9, 4, 0.5),
    (2000, 5850, 128, 80 / 5850)])
def test_kernels_match_plain_versions(cuda, m, g, h, density):
    x, packed, w, g_out = _inputs(m, g, h, density, seed=m + g)
    w16, g16 = w.bfloat16().float(), g_out.bfloat16().float()
    _assert_close(pm.packed_matmul_fwd(packed, w),
                  pm.packed_matmul_fwd_plain(packed, w), x @ w16.abs())
    _assert_close(pm.packed_matmul_bwd(packed, g_out, g),
                  pm.packed_matmul_bwd_plain(packed, g_out, g),
                  x.T @ g16.abs())
    torch.cuda.synchronize()


def test_forward_is_m_invariant_and_backward_reproducible(cuda):
    _, packed, w, g_out = _inputs(1500, 700, 128, 0.03, seed=1)
    full = pm.packed_matmul_fwd(packed, w)
    for rows in (1, 129, 1000):
        assert torch.equal(pm.packed_matmul_fwd(packed[:rows], w),
                           full[:rows])
    dw = pm.packed_matmul_bwd(packed, g_out, 700)
    assert torch.equal(pm.packed_matmul_bwd(packed, g_out, 700), dw)


@pytest.mark.parametrize("h", [1, 6, 10, 130])
def test_any_hidden_width_on_the_card(cuda, h):
    x, packed, w, g_out = _inputs(700, 301, h, 0.05, seed=h)
    w16, g16 = w.bfloat16().float(), g_out.bfloat16().float()
    out = pm.packed_matmul_fwd(packed, w)
    assert out.shape == (700, h) and out.is_contiguous()
    _assert_close(out, pm.packed_matmul_fwd_plain(packed, w), x @ w16.abs())
    dw = pm.packed_matmul_bwd(packed, g_out, 301)
    assert dw.shape == (301, h) and dw.is_contiguous()
    _assert_close(dw, pm.packed_matmul_bwd_plain(packed, g_out, 301),
                  x.T @ g16.abs())
    tw = w.clone().requires_grad_()
    (pm.packed_matmul(packed, tw, grad_rows=500) * g_out).sum().backward()
    _assert_close(tw.grad, pm.packed_matmul_bwd_plain(
        packed[:500], g_out[:500], 301), x[:500].T @ g16[:500].abs())


def _slice_edges(g, h):
    """M one below, at and one above each of the first two row counts at
    which the backward's planned slice count changes."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges, prev = [], pm._bwd_slices(1, g, h, n_sms).n_slices
    for m in range(2, 5000):
        n = pm._bwd_slices(m, g, h, n_sms).n_slices
        if n != prev:
            edges += [m - 1, m, m + 1]
            prev = n
        if len(edges) == 6:
            return edges
    raise AssertionError("the plan never splits below 5000 rows")


def test_backward_at_k_step_and_slice_edges(cuda):
    g, h = 700, 128
    rows = [16 * k + d for k in (1, 2, 4, 5) for d in (-1, 1)]
    for m in rows + _slice_edges(g, h):
        x, packed, _, g_out = _inputs(m, g, h, 0.05, seed=m)
        _assert_close(pm.packed_matmul_bwd(packed, g_out, g),
                      pm.packed_matmul_bwd_plain(packed, g_out, g),
                      x.T @ g_out.bfloat16().float().abs())


@pytest.mark.parametrize("m,n_slices,rows", [
    (129, 3, 64), (400, 7, 64), (1000, 2, 960), (64, 1, 64)])
def test_backward_under_forced_splits(cuda, m, n_slices, rows):
    """Slices of one stage, a last slice of one row, many slices: each
    plan the kernel may be handed gives the plain version's dW."""
    g, h = 1003, 136
    x, packed, _, g_out = _inputs(m, g, h, 0.04, seed=m + n_slices)
    g16 = g_out.bfloat16()
    plan = pm.BwdSlices(n_slices, rows, n_slices * g * h * 4)
    assert plan.bounds(m)[-1][0] < m <= plan.bounds(m)[-1][1]
    _assert_close(pm._bwd_on_card(packed, g16, g, plan),
                  pm.packed_matmul_bwd_plain(packed, g_out, g),
                  x.T @ g16.float().abs())


def test_backward_refuses_misaligned_packed_and_short_splits(cuda):
    """P reaches 4-byte cp.async copies, and a split must cover every row:
    the wrapper raises before a launch could fault or drop rows."""
    _, packed, _, g_out = _inputs(200, 64, 8, 0.1, seed=6)
    flat = torch.empty(200 * 8 + 1, dtype=torch.uint8, device="cuda")
    shifted = flat[1:].view(200, 8)
    shifted.copy_(packed)
    with pytest.raises(ValueError, match="4-byte aligned"):
        pm.packed_matmul_bwd(shifted, g_out, 64)
    with pytest.raises(ValueError, match="does not cover"):
        pm._bwd_on_card(packed, g_out.bfloat16(), 64, pm.BwdSlices(3, 64, 0))
    _assert_close(pm._bwd_on_card(packed, g_out.bfloat16(), 64,
                                  pm.BwdSlices(4, 64, 0)),
                  pm.packed_matmul_bwd_plain(packed, g_out, 64),
                  pm.unpack_bits(packed, 64).float().T
                  @ g_out.bfloat16().float().abs())


def test_backward_is_bitwise_the_same_across_calls_and_streams(cuda):
    _, packed, _, g_out = _inputs(5000, 1500, 128, 0.02, seed=9)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pm._bwd_slices(5000, 1500, 128, n_sms).n_slices > 1
    first = pm.packed_matmul_bwd(packed, g_out, 1500)
    assert torch.equal(pm.packed_matmul_bwd(packed, g_out, 1500), first)
    results = []
    for _ in range(2):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            results.append(pm.packed_matmul_bwd(packed, g_out, 1500))
        torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in results)


def test_kernel_source_has_no_atomics():
    """dW's reproducibility rests on fixed-order sums: no atomic add and
    no reduction instruction anywhere in the kernels' source."""
    import re

    with open(pm.SRC) as f:
        src = f.read()
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert not re.search(r"\b(red|atom)\.", src)


def test_autograd_on_the_card_matches_the_cpu(cuda):
    _, packed, w, g_out = _inputs(300, 260, 16, 0.05, seed=2)
    grads = []
    for dev in ("cuda", "cpu"):
        tw = w.to(dev).bfloat16().requires_grad_()
        out = pm.packed_matmul(packed.to(dev), tw, grad_rows=200)
        (out * g_out.to(dev)).sum().backward()
        assert tw.grad.dtype == torch.bfloat16
        grads.append(tw.grad.float().cpu())
    # dW is rounded to bf16 on both sides: one bf16 ulp apart at most.
    ulp = grads[1].abs() * 2.0 ** -7
    assert bool(((grads[0] - grads[1]).abs() <= ulp).all())


def test_counters_count_card_launches_only(cuda):
    _, packed, w, g_out = _inputs(64, 100, 8, 0.1, seed=3)
    pm.reset_launch_counts()
    pm.packed_matmul_fwd(packed.cpu(), w.cpu())
    pm.packed_matmul_fwd_plain(packed, w)
    assert pm.packed_matmul_fwd.launches == 0
    pm.packed_matmul_fwd(packed, w)
    pm.packed_matmul_bwd(packed, g_out, 100)
    pm.packed_matmul_bwd(packed, g_out, 100)
    assert (pm.packed_matmul_fwd.launches,
            pm.packed_matmul_bwd.launches) == (1, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    _, packed, w, g_out = _inputs(32, 64, 8, 0.1, seed=4)
    with pytest.raises(ValueError, match="contiguous"):
        pm.packed_matmul_fwd(packed.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(64 * 8 + 1, dtype=torch.bfloat16, device="cuda")
        pm.packed_matmul_fwd(packed, flat[1:].view(64, 8))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.empty(32 * 8 + 4, dtype=torch.bfloat16, device="cuda")
        pm.packed_matmul_bwd(packed, flat[4:].view(32, 8), 64)
    with pytest.raises(ValueError, match="packed on"):
        pm.packed_matmul_fwd(packed, w.cpu())


def test_trainer_on_the_card_tracks_the_cpu(cuda):
    from g2vec_tpu_torch.train.trainer import train_cbow
    from g2vec_tpu_torch.weights import params_from_jax

    rng = np.random.default_rng(5)
    dense = rng.random((600, 500)) < 0.05
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    wi = (np.clip(rng.standard_normal((500, 128)), -2, 2)
          / np.sqrt(128)).astype(np.float32)
    wo = (np.clip(rng.standard_normal((128, 1)), -2, 2)
          / np.sqrt(128)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        pm.reset_launch_counts()
        runs[dev] = train_cbow(np.packbits(dense, axis=1), labels,
                               n_genes=500, hidden=128, learning_rate=0.002,
                               max_epochs=20, seed=3, device=dev,
                               init=params_from_jax(wi, wo))
        if dev == "cuda":
            epochs = len(runs[dev].history)
            assert pm.packed_matmul_fwd.launches == epochs + 1
            assert pm.packed_matmul_bwd.launches == epochs
    a, b = runs["cuda"], runs["cpu"]
    assert (a.stop_epoch, len(a.history)) == (b.stop_epoch, len(b.history))
    for ha, hb in zip(a.history, b.history):
        assert abs(ha["acc_val"] - hb["acc_val"]) <= 0.01
        np.testing.assert_allclose(ha["loss"], hb["loss"], rtol=1e-4)
    np.testing.assert_allclose(a.w_ih, b.w_ih, rtol=0, atol=1e-4)
