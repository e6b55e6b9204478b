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
    with pytest.raises(ValueError, match="H % 4"):
        pm.packed_matmul_fwd(packed, w[:, :6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        pm.packed_matmul_fwd(packed.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(64 * 8 + 1, dtype=torch.bfloat16, device="cuda")
        pm.packed_matmul_fwd(packed, flat[1:].view(64, 8))
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
