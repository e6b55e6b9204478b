"""The modified-CBOW trainer (ref: compute_genetovec, G2Vec.py:217-286).

Reference behaviour, as ``g2vec_tpu/train/trainer.py`` reproduces it:

- seeded shuffled 80/20 hold-out (ref: G2Vec.py:219-226);
- full-batch training: the whole train split in every optimizer step
  (ref: G2Vec.py:264);
- Adam with TF1 defaults (b1=0.9, b2=0.999, eps=1e-8; ref: G2Vec.py:246),
  written out in optax's arithmetic order;
- after each step, val and train accuracies are taken at the UPDATED
  weights (ref: G2Vec.py:264-267);
- early stop on the FIRST strict decrease of val accuracy, returning the
  PREVIOUS epoch's embedding table (ref: G2Vec.py:276-283);
- ``max_epochs`` caps the loop.

The epoch is the JAX package's fused-eval epoch without its XLA
machinery (while_loop chunks, supersteps, buffer donation): epoch i's
forward at its entry weights — which are epoch i-1's updated weights —
gives both epoch i's train loss and epoch i-1's accuracies, so each epoch
is ONE forward launch over the ``[train | val]`` rows and ONE backward
launch over the train rows. On the bf16 path both are the packed kernels
(:mod:`g2vec_tpu_torch.ops.packed_matmul`); the forward's M-invariance is
what lets the val rows ride the train rows' launch. ``compute_dtype=
"float32"`` runs the dense product with ``torch.matmul`` per split, as the
JAX package's XLA path does — the tight-tolerance path of the tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from g2vec_tpu_torch.device import resolve_device
from g2vec_tpu_torch.models.cbow import (CBOW, accuracy_from_logits,
                                         init_params, masked_bce_loss,
                                         output_logits, torch_dtype)
from g2vec_tpu_torch.ops.packed_matmul import (packed_matmul,
                                               padded_row_bytes, unpack_bits)

#: Adam hyperparameters, TF1 defaults (ref: G2Vec.py:246).
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainResult:
    w_ih: np.ndarray            # [n_genes, hidden] float32 — the embeddings
    stop_epoch: int             # reported stop epoch (reference convention)
    stopped_early: bool
    acc_val: float              # accuracy pair at the reported epoch
    acc_tr: float
    history: List[dict]         # per-epoch {epoch, acc_val, acc_tr, loss, secs}
    model: CBOW                 # the returned epoch's parameters, on the
                                # training device (stage 5 reads them there)


def _split_indices(n_paths: int, seed: int, val_fraction: float):
    """The shuffled 80/20 hold-out split (ref: G2Vec.py:219-226), seeded
    exactly as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_paths)
    pivot = int(n_paths * (1.0 - val_fraction))
    if pivot in (0, n_paths):
        raise ValueError(
            f"val_fraction={val_fraction} leaves an empty split for "
            f"{n_paths} paths")
    return perm[:pivot], perm[pivot:]


def _pack_split(paths: np.ndarray, labels: np.ndarray, idx: np.ndarray):
    """One split's packed rows, labels [n, 1] and row mask [n, 1] (all
    ones: the kernels take any row count, so no row is padding)."""
    y = labels[idx].astype(np.float32)[:, None]
    return paths[idx], y, np.ones_like(y)


def _fused_rows(p_tr: np.ndarray, p_val: np.ndarray,
                n_genes: int) -> np.ndarray:
    """The ``[train | val]`` packed matrix of one run: train rows keep
    their offsets and the val rows follow, each row padded with zero bytes
    to the kernels' row stride (a multiple of 4 bytes), so that no launch
    of the run copies P to pad it."""
    n_tr, nb = p_tr.shape
    rows = np.zeros((n_tr + p_val.shape[0], padded_row_bytes(n_genes)),
                    np.uint8)
    rows[:n_tr, :nb] = p_tr
    rows[n_tr:, :nb] = p_val
    return rows


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count`` in float32 (the f32 power of the f32
    decay, then the f32 subtraction)."""
    power = np.float32(float(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


class _Adam:
    """``optax.adam`` in its own arithmetic order: moments
    ``(1-b)*g + b*m``, bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``,
    update ``p + (-lr) * u``. (``torch.optim.Adam`` folds the bias
    correction into the step size and rounds differently.)"""

    def __init__(self, params: List[torch.Tensor], learning_rate: float):
        self.lr = learning_rate
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor]) -> None:
        """Update ``params`` in place from their ``.grad``."""
        self.count += 1
        bc1 = _bias_correction(_ADAM_B1, self.count)
        bc2 = _bias_correction(_ADAM_B2, self.count)
        for i, p in enumerate(params):
            g = p.grad
            self.mu[i] = (1 - _ADAM_B1) * g + _ADAM_B1 * self.mu[i]
            self.nu[i] = (1 - _ADAM_B2) * (g * g) + _ADAM_B2 * self.nu[i]
            update = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                           + _ADAM_EPS)
            p.add_((-self.lr) * update)
            p.grad = None


def train_cbow(paths: np.ndarray, labels: np.ndarray, *, n_genes: int,
               hidden: int, learning_rate: float, max_epochs: int,
               val_fraction: float = 0.2, decision_threshold: float = 0.5,
               compute_dtype: str = "bfloat16", param_dtype: str = "float32",
               seed: int = 0, device="cuda", init: Optional[CBOW] = None,
               on_epoch: Optional[Callable[[int, float, float, float], None]] = None
               ) -> TrainResult:
    """Train the modified CBOW; returns the embedding table and history.

    ``paths``: [n_paths, ceil(n_genes/8)] uint8 bit-packed multi-hot rows
    (np.packbits order, as ``integrate_path_sets`` returns them);
    ``labels``: [n_paths] in {0, 1}. ``init`` replaces the seeded draw
    (the tests pass the JAX package's init through
    :func:`g2vec_tpu_torch.weights.params_from_jax`); it is copied, never
    modified. ``on_epoch(step, acc_val, acc_tr, secs)`` fires every epoch.
    """
    dev = resolve_device(device)
    n_paths = paths.shape[0]
    if n_paths < 2:
        raise ValueError(f"need at least 2 paths to split, got {n_paths}")
    if paths.dtype != np.uint8 or paths.shape[1] != (n_genes + 7) // 8:
        raise ValueError(
            f"n_genes={n_genes} expects uint8 paths of width "
            f"{(n_genes + 7) // 8}, got {paths.dtype} width {paths.shape[1]}")
    torch_dtype(compute_dtype)
    pdtype = torch_dtype(param_dtype)

    tr_idx, vl_idx = _split_indices(n_paths, seed, val_fraction)
    p_tr, y_tr, w_tr = _pack_split(paths, labels, tr_idx)
    p_val, y_val, w_val = _pack_split(paths, labels, vl_idx)
    n_tr = p_tr.shape[0]
    # The val rows ride the train rows' forward launch.
    x_all = torch.from_numpy(_fused_rows(p_tr, p_val, n_genes)).to(dev)
    y_tr, w_tr, y_val, w_val = (torch.from_numpy(a).to(dev)
                                for a in (y_tr, w_tr, y_val, w_val))
    if compute_dtype == "float32":
        x_dense = unpack_bits(x_all, n_genes, torch.float32)
        x_tr, x_val = x_dense[:n_tr], x_dense[n_tr:]

    if init is None:
        init = init_params(n_genes, hidden,
                           torch.Generator().manual_seed(seed))
    if tuple(init.w_ih.shape) != (n_genes, hidden):
        raise ValueError(f"init w_ih {tuple(init.w_ih.shape)} vs "
                         f"({n_genes}, {hidden})")
    model = CBOW(init.w_ih.detach().to(device=dev, dtype=pdtype).clone(),
                 init.w_ho.detach().to(device=dev, dtype=pdtype).clone())
    params = [model.w_ih, model.w_ho]
    adam = _Adam(params, learning_rate)
    logit_threshold = float(np.log(decision_threshold
                                   / (1.0 - decision_threshold)))

    def split_logits():
        if compute_dtype == "float32":
            logits_tr = model(x_tr, compute_dtype)
            with torch.no_grad():
                logits_val = model(x_val, compute_dtype)
            return logits_tr, logits_val
        h = packed_matmul(x_all, model.w_ih.to(torch.bfloat16),
                          grad_rows=n_tr)
        logits = output_logits(h, model.w_ho, compute_dtype)
        return logits[:n_tr], logits[n_tr:]

    def accuracy(logits, y, w) -> float:
        return float(accuracy_from_logits(logits.detach(), y, w,
                                          logit_threshold))

    history: List[dict] = []
    before_val, before_tr = -1.0, -1.0
    snapshot = [p.detach().clone() for p in params]
    stopped_early = False
    stop_epoch = max_epochs - 1
    t0 = time.perf_counter()
    # Iteration e runs epoch e's forward at its entry weights; for e > 0
    # those are epoch e-1's updated weights, so the same logits report and
    # dip-test epoch e-1 before update e is applied. The extra iteration
    # e == max_epochs only reports the last epoch.
    for epoch in range(max_epochs + 1):
        train = epoch < max_epochs
        with torch.set_grad_enabled(train):
            logits_tr, logits_val = split_logits()
        if epoch > 0:
            acc_val = accuracy(logits_val, y_val, w_val)
            acc_tr = accuracy(logits_tr, y_tr, w_tr)
            now = time.perf_counter()
            secs, t0 = now - t0, now
            history[-1].update(acc_val=acc_val, acc_tr=acc_tr, secs=secs)
            if on_epoch is not None:
                on_epoch(epoch - 1, acc_val, acc_tr, secs)
            if acc_val < before_val:
                # First strict dip: epoch e-1's update is discarded and the
                # snapshot keeps epoch e-2's weights (ref: the
                # fetch-after-break ordering at G2Vec.py:276-283).
                stopped_early = True
                stop_epoch = epoch - 2
                break
            snapshot = [p.detach().clone() for p in params]
            before_val, before_tr = acc_val, acc_tr
        if not train:
            break
        loss = masked_bce_loss(logits_tr, y_tr, w_tr)
        loss.backward()
        adam.step(params)
        history.append({"epoch": epoch, "acc_val": float("nan"),
                        "acc_tr": float("nan"), "loss": loss.item(),
                        "secs": 0.0})

    best = CBOW(*snapshot)
    return TrainResult(
        w_ih=best.w_ih.detach().float().cpu().numpy(), stop_epoch=stop_epoch,
        stopped_early=stopped_early, acc_val=before_val, acc_tr=before_tr,
        history=history, model=best)
