"""The port's full-batch trainer against ``g2vec_tpu.train.train_cbow``.

Both sides start from the same numpy init (the JAX side through
``warm_start``, the port through ``params_from_jax``) on the same packed
paths, split seed and hyperparameters.

- float32: the port's dense torch.matmul path against JAX's XLA path
  (``compute_dtype="float32"``, ``use_pallas=False``). Per-epoch
  accuracies, the stop epoch and the stop decision are equal; losses and
  W_ih agree at rtol 1e-5 (W_ih with atol 1e-7 for entries near zero —
  float32 sums in a different order, compounded through Adam).
- bfloat16 kernel path: the port's plain path against JAX's Pallas kernels
  in interpret mode (``use_pallas=True``) at hidden 128. The JAX package's
  own pallas-vs-XLA test allows |dloss| < 0.05, |dacc_tr| < 0.12 and W atol
  0.05; tighter bounds hold and are pinned: equal accuracies and stop
  epoch, losses at rtol 1e-4, W_ih at atol 1e-4 (dW is rounded to bf16 on
  both sides, so a one-ulp rounding difference in dW can move an Adam
  update).
"""
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from g2vec_tpu.models import cbow as jcbow
from g2vec_tpu.train.trainer import train_cbow as jax_train
from g2vec_tpu_torch.models import cbow as tcbow
from g2vec_tpu_torch.train import trainer as ttrainer
from g2vec_tpu_torch.weights import params_from_jax

pytestmark = pytest.mark.torch


def _problem(rng, n_paths, n_genes, hidden, density=0.05):
    dense = rng.random((n_paths, n_genes)) < density
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    wi = (np.clip(rng.standard_normal((n_genes, hidden)), -2, 2)
          / np.sqrt(hidden)).astype(np.float32)
    wo = (np.clip(rng.standard_normal((hidden, 1)), -2, 2)
          / np.sqrt(hidden)).astype(np.float32)
    return np.packbits(dense, axis=1), labels, wi, wo


def _both(rng, n_paths, n_genes, hidden, compute_dtype, **kw):
    packed, labels, wi, wo = _problem(rng, n_paths, n_genes, hidden)
    common = dict(hidden=hidden, compute_dtype=compute_dtype, seed=3, **kw)
    rj = jax_train(packed, labels, packed_genes=n_genes,
                   use_pallas=(compute_dtype == "bfloat16"),
                   warm_start=(wi, wo), **common)
    rt = ttrainer.train_cbow(packed, labels, n_genes=n_genes, device="cpu",
                             init=params_from_jax(wi, wo), **common)
    return rj, rt


def _assert_same_trajectory(rj, rt, loss_rtol):
    assert (rt.stop_epoch, rt.stopped_early) == (rj.stop_epoch,
                                                 rj.stopped_early)
    assert len(rt.history) == len(rj.history)
    for a, b in zip(rj.history, rt.history):
        assert b["epoch"] == a["epoch"]
        assert (b["acc_val"], b["acc_tr"]) == (a["acc_val"], a["acc_tr"])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=loss_rtol)
    assert (rt.acc_val, rt.acc_tr) == (rj.acc_val, rj.acc_tr)


@pytest.mark.parametrize("max_epochs,lr", [(40, 0.01), (3, 0.002)],
                         ids=["early_stop", "epoch_cap"])
def test_float32_matches_jax(rng, max_epochs, lr):
    rj, rt = _both(rng, 300, 300, 32, "float32", learning_rate=lr,
                   max_epochs=max_epochs)
    assert rj.stopped_early == (max_epochs == 40)
    _assert_same_trajectory(rj, rt, loss_rtol=1e-5)
    np.testing.assert_allclose(rt.w_ih, rj.w_ih, rtol=1e-5, atol=1e-7)


def test_bf16_kernel_path_matches_jax_pallas(rng):
    rj, rt = _both(rng, 640, 700, 128, "bfloat16", learning_rate=0.002,
                   max_epochs=30)
    assert len(rj.history) >= 3
    _assert_same_trajectory(rj, rt, loss_rtol=1e-4)
    np.testing.assert_allclose(rt.w_ih, rj.w_ih, rtol=0, atol=1e-4)


def test_odd_hidden_width_matches_jax(rng):
    """hidden 10, as ``-s 10`` asks: the JAX trainer takes its dense path
    at that width (Pallas needs hidden % 128 == 0), and the port the same
    bf16 product it runs on the card."""
    packed, labels, wi, wo = _problem(rng, 640, 700, 10)
    common = dict(hidden=10, compute_dtype="bfloat16", seed=3,
                  learning_rate=0.002, max_epochs=30)
    rj = jax_train(packed, labels, packed_genes=700, use_pallas=False,
                   warm_start=(wi, wo), **common)
    rt = ttrainer.train_cbow(packed, labels, n_genes=700, device="cpu",
                             init=params_from_jax(wi, wo), **common)
    assert rt.w_ih.shape == (700, 10)
    _assert_same_trajectory(rj, rt, loss_rtol=1e-4)
    np.testing.assert_allclose(rt.w_ih, rj.w_ih, rtol=0, atol=1e-4)


def test_pack_split_matches_jax(rng):
    from g2vec_tpu.train.trainer import _pack_split as jpack

    packed, labels, _, _ = _problem(rng, 97, 128, 4)
    for idx in ttrainer._split_indices(97, 2, 0.2):
        got = ttrainer._pack_split(packed, labels, idx)
        # The JAX packing without row or gene padding, on its XLA layout
        # (np.packbits rows, the layout the port's kernels read).
        want = jpack(packed, labels, idx, packed_genes=128, n_genes=128,
                     n_genes_pad=128, row_multiple=1, use_pallas=False)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_split_matches_jax():
    from g2vec_tpu.train.trainer import _split_indices as jsplit

    for n, seed in ((10, 0), (977, 5)):
        for a, b in zip(ttrainer._split_indices(n, seed, 0.2),
                        jsplit(n, seed, 0.2)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="empty split"):
        ttrainer._split_indices(3, 0, 0.7)


def test_adam_matches_optax(rng):
    shapes = [(7, 5), (5, 1)]
    params_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads_np = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
                for _ in range(6)]
    tx = optax.adam(0.005, b1=0.9, b2=0.999, eps=1e-8)
    jp = [jnp.asarray(p) for p in params_np]
    state = tx.init(jp)
    tp = [torch.tensor(p) for p in params_np]
    adam = ttrainer._Adam(tp, 0.005)
    for step_grads in grads_np:
        updates, state = tx.update([jnp.asarray(g) for g in step_grads],
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step_grads):
            p.grad = torch.tensor(g)
        adam.step(tp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)


def test_loss_and_accuracy_match_jax(rng):
    logits = (rng.standard_normal((50, 1)) * 4).astype(np.float32)
    y = (rng.random((50, 1)) < 0.5).astype(np.float32)
    w = np.ones((50, 1), np.float32)
    w[45:] = 0.0
    lt = tcbow.masked_bce_loss(torch.tensor(logits), torch.tensor(y),
                               torch.tensor(w))
    lj = jcbow.masked_bce_loss(jnp.asarray(logits), jnp.asarray(y),
                               jnp.asarray(w))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    for thr in (0.0, 0.4):
        at = tcbow.accuracy_from_logits(torch.tensor(logits), torch.tensor(y),
                                        torch.tensor(w), thr)
        aj = jcbow.accuracy_from_logits(jnp.asarray(logits), jnp.asarray(y),
                                        jnp.asarray(w), thr)
        assert float(at) == float(aj)


def test_seeded_init_and_params_from_jax():
    a = tcbow.init_params(30, 16, torch.Generator().manual_seed(4))
    b = tcbow.init_params(30, 16, torch.Generator().manual_seed(4))
    assert torch.equal(a.w_ih, b.w_ih) and torch.equal(a.w_ho, b.w_ho)
    assert a.w_ih.shape == (30, 16) and a.w_ho.shape == (16, 1)
    assert float(a.w_ih.detach().abs().max()) <= 2.0 / 4.0
    m = params_from_jax(np.ones((3, 2), np.float32),
                        np.ones((2, 1), np.float32), pad_to=5)
    assert m.w_ih.shape == (5, 2) and not m.w_ih[3:].any()


def test_trainer_rejects_bad_input():
    with pytest.raises(ValueError, match="width"):
        ttrainer.train_cbow(np.zeros((4, 3), np.uint8), np.zeros(4), n_genes=8,
                            hidden=4, learning_rate=0.1, max_epochs=1,
                            device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        ttrainer.train_cbow(np.zeros((1, 1), np.uint8), np.zeros(1), n_genes=8,
                            hidden=4, learning_rate=0.1, max_epochs=1,
                            device="cpu")
