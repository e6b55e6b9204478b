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

Checkpoint/resume (``checkpoint_dir``, ``resume``, ``checkpoint_every``)
has the JAX package's semantics (``g2vec_tpu/train/trainer.py``): a save
every ``checkpoint_every`` epochs counted from where the run started, and
once at the end with the terminal ``done`` code; a resumed terminal early
stop returns its snapshot without training, and a completed run goes on
when ``max_epochs`` was raised. The ``train`` fault seam fires once per
epoch, after the epoch is reported and before that boundary's save. The
state the JAX package saves after epoch k exists here inside iteration
k+1 (after the report and the dip test, before update k+1), so the
checkpoint is cut there; a resumed run's first iteration re-runs that
forward for its loss only, and Adam's step count comes back with its
moments. Resumed and uninterrupted runs give the same bytes.
``checkpoint_layout`` picks the file layout (``train/checkpoint.py``).

Under a mesh (``mesh_ctx``, ``--mesh``) the JAX package turns fused eval
off (``g2vec_tpu/train/trainer.py:1005``), and so does the port: the val
rows take a forward launch of their own, so an epoch is two forward
launches and one backward. The forward is bitwise M-invariant, so the
outputs do not change. The port trains on one device: a multi-process
mesh run gives each rank a 1x1 local mesh (``parallel/distributed.py``),
on which the shard-even padding is the identity; a mesh over several
devices in one process is refused.

:func:`train_cbow_lanes` trains a bucket of B lanes of one path-matrix
shape (the batch engine's runs that differ in seeds and data) as the
reference's ``train_cbow_lanes`` does (``g2vec_tpu/train/trainer.py``,
a vmap of the chunk program there): the same split, packing and init per
lane, each lane's own first-dip stop. On the bf16 path each epoch is ONE
forward launch and ONE backward launch for all the lanes still training
(``packed_matmul_lanes_fwd``/``_bwd``); everything between them runs per
lane with the solo step's ops, so every lane's history, stop epoch and
``W_ih`` are bitwise the solo :func:`train_cbow`'s on the same device. At
float32 the lane step is the solo step, per lane.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from g2vec_tpu_torch.device import resolve_device
from g2vec_tpu_torch.models.cbow import (CBOW, accuracy_from_logits,
                                         init_params, masked_bce_loss,
                                         output_logits, torch_dtype)
from g2vec_tpu_torch.ops.packed_matmul import (packed_matmul,
                                               packed_matmul_lanes_bwd,
                                               packed_matmul_lanes_fwd,
                                               padded_row_bytes, unpack_bits)
from g2vec_tpu_torch.resilience.faults import fault_point
from g2vec_tpu_torch.train.checkpoint import (RUN_COMPLETED,
                                              RUN_EARLY_STOPPED,
                                              RUN_IN_PROGRESS, load_state,
                                              save_state)

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
    tile_plans: Optional[dict] = None  # --kernel-autotune: the packed
                                # kernels' plan per launch row count


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

    def state(self):
        """``(count, mu, nu)``: optax's ``ScaleByAdamState`` leaves."""
        return self.count, tuple(self.mu), tuple(self.nu)

    def load(self, state, device) -> None:
        """Restore :meth:`state`'s tuple (CPU tensors from a checkpoint)."""
        count, mu, nu = state
        self.count = int(count)
        self.mu = [m.to(device) for m in mu]
        self.nu = [n.to(device) for n in nu]


def train_cbow(paths: np.ndarray, labels: np.ndarray, *, n_genes: int,
               hidden: int, learning_rate: float, max_epochs: int,
               val_fraction: float = 0.2, decision_threshold: float = 0.5,
               compute_dtype: str = "bfloat16", param_dtype: str = "float32",
               seed: int = 0, device="cuda", init: Optional[CBOW] = None,
               on_epoch: Optional[Callable[[int, float, float, float], None]] = None,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               checkpoint_every: int = 25,
               check: Optional[Callable[[], None]] = None,
               debug_nans: bool = False, mesh_ctx=None,
               checkpoint_layout: str = "single",
               kernel_autotune: bool = False,
               autotune_cache_path: Optional[str] = None) -> TrainResult:
    """Train the modified CBOW; returns the embedding table and history.

    ``paths``: [n_paths, ceil(n_genes/8)] uint8 bit-packed multi-hot rows
    (np.packbits order, as ``integrate_path_sets`` returns them);
    ``labels``: [n_paths] in {0, 1}. ``init`` replaces the seeded draw
    (the tests pass the JAX package's init through
    :func:`g2vec_tpu_torch.weights.params_from_jax`); it is copied, never
    modified. ``on_epoch(step, acc_val, acc_tr, secs)`` fires every epoch.
    ``checkpoint_dir``/``resume``/``checkpoint_every``/
    ``checkpoint_layout``: module docstring.
    ``check()`` runs before each epoch; an exception it raises stops the
    run there. ``debug_nans`` (``--debug-nans``) raises at the first
    non-finite loss or gradient (:func:`check_finite`). ``mesh_ctx`` (a
    ``parallel.mesh.MeshContext``) is the run's mesh: one device, and
    fused eval off. ``kernel_autotune`` (``--kernel-autotune``) sweeps or
    loads the packed kernels' tile plans at this run's exact launch shapes,
    each in the directions it launches, before the first epoch, persisted
    under ``autotune_cache_path``
    (:func:`_autotune_packed_shapes`); a run on the CPU or at float32
    launches no packed kernel and skips it.
    """
    dev = resolve_device(device)
    fused = mesh_ctx is None or mesh_ctx.mesh is None
    if mesh_ctx is not None and mesh_ctx.n_devices > 1:
        raise NotImplementedError(
            f"mesh {mesh_ctx.shape} spans {mesh_ctx.n_devices} devices in "
            f"one process; the port trains on one device (a multi-process "
            f"--distributed --mesh run gives each rank a 1x1 local mesh)")
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
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
    tile_plans = None
    if kernel_autotune and dev.type == "cuda" and compute_dtype == "bfloat16":
        # The fused forward runs at [train | val] rows and the backward
        # at the train rows; without fused eval the forward runs at each.
        # Each shape is timed in the directions it launches.
        n_all = x_all.shape[0]
        tile_plans = _autotune_packed_shapes(
            [(n_all if fused else n_tr, "fwd"), (n_tr, "bwd")]
            + ([] if fused else [(n_all - n_tr, "fwd")]), n_genes, hidden,
            dev, autotune_cache_path)

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
        w16 = model.w_ih.to(torch.bfloat16)
        if not fused:
            # The val rows in a launch of their own.
            h_tr = packed_matmul(x_all[:n_tr], w16)
            with torch.no_grad():
                h_val = packed_matmul(x_all[n_tr:], w16)
            return (output_logits(h_tr, model.w_ho, compute_dtype),
                    output_logits(h_val, model.w_ho, compute_dtype))
        h = packed_matmul(x_all, w16, grad_rows=n_tr)
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
    start_epoch = 0
    # Recorded in the checkpoint manifest and checked on resume (the JAX
    # package's keys; its n_genes_pad is the port's unpadded gene count).
    # max_epochs is absent: raising it continues a completed run.
    fingerprint = {
        "hidden": hidden, "learning_rate": learning_rate,
        "compute_dtype": compute_dtype, "param_dtype": param_dtype,
        "seed": seed, "val_fraction": val_fraction,
        "decision_threshold": decision_threshold, "n_genes_pad": n_genes,
    }
    if checkpoint_dir and resume:
        restored = load_state(checkpoint_dir, params, adam.state(),
                              fingerprint=fingerprint,
                              layout=checkpoint_layout)
        if restored is not None:
            (w_params, opt_state, w_snap, last_epoch, before_val, before_tr,
             done) = restored
            with torch.no_grad():
                for p, w in zip(params, w_params):
                    p.copy_(w)
            adam.load(opt_state, dev)
            snapshot = [w.to(dev) for w in w_snap]
            if (done == RUN_EARLY_STOPPED
                    or (done != RUN_IN_PROGRESS
                        and last_epoch + 1 >= max_epochs)):
                # Terminal: an early stop is final, and a completed run
                # with no more epoch budget has nothing to do.
                best = CBOW(*snapshot)
                return TrainResult(
                    w_ih=best.w_ih.detach().float().cpu().numpy(),
                    stop_epoch=last_epoch,
                    stopped_early=(done == RUN_EARLY_STOPPED),
                    acc_val=before_val, acc_tr=before_tr, history=[],
                    model=best, tile_plans=tile_plans)
            start_epoch = last_epoch + 1

    def save(epoch: int, done: int = RUN_IN_PROGRESS) -> None:
        save_state(checkpoint_dir, params, adam.state(), snapshot, epoch,
                   before_val, before_tr, done=done, fingerprint=fingerprint,
                   layout=checkpoint_layout)

    t0 = time.perf_counter()
    # Iteration e runs epoch e's forward at its entry weights; for e past
    # the first those are epoch e-1's updated weights, so the same logits
    # report and dip-test epoch e-1 before update e is applied. The extra
    # iteration e == max_epochs only reports the last epoch. A resumed
    # run's first iteration reports nothing: its epoch was reported before
    # the checkpoint was cut.
    for epoch in range(start_epoch, max_epochs + 1):
        if check is not None:
            check()
        train = epoch < max_epochs
        with torch.set_grad_enabled(train):
            logits_tr, logits_val = split_logits()
        if epoch > start_epoch:
            acc_val = accuracy(logits_val, y_val, w_val)
            acc_tr = accuracy(logits_tr, y_tr, w_tr)
            now = time.perf_counter()
            secs, t0 = now - t0, now
            history[-1].update(acc_val=acc_val, acc_tr=acc_tr, secs=secs)
            if on_epoch is not None:
                on_epoch(epoch - 1, acc_val, acc_tr, secs)
            fault_point("train", epoch=epoch - 1)
            if acc_val < before_val:
                # First strict dip: epoch e-1's update is discarded and the
                # snapshot keeps epoch e-2's weights (ref: the
                # fetch-after-break ordering at G2Vec.py:276-283).
                stopped_early = True
                stop_epoch = epoch - 2
                break
            snapshot = [p.detach().clone() for p in params]
            before_val, before_tr = acc_val, acc_tr
            # The JAX package's chunk boundary: every checkpoint_every
            # epochs from where this run started, and the last epoch.
            if checkpoint_dir and ((epoch - start_epoch) % checkpoint_every
                                   == 0 or epoch == max_epochs):
                save(epoch - 1)
        if not train:
            break
        loss = masked_bce_loss(logits_tr, y_tr, w_tr)
        if debug_nans:
            check_finite(loss, f"loss (masked_bce_loss) at epoch {epoch}")
        loss.backward()
        if debug_nans:
            check_gradients(params, f"at epoch {epoch}")
        adam.step(params)
        history.append({"epoch": epoch, "acc_val": float("nan"),
                        "acc_tr": float("nan"), "loss": loss.item(),
                        "secs": 0.0})

    if checkpoint_dir:
        save(stop_epoch if stopped_early else max_epochs - 1,
             RUN_EARLY_STOPPED if stopped_early else RUN_COMPLETED)
    best = CBOW(*snapshot)
    return TrainResult(
        w_ih=best.w_ih.detach().float().cpu().numpy(), stop_epoch=stop_epoch,
        stopped_early=stopped_early, acc_val=before_val, acc_tr=before_tr,
        history=history, model=best, tile_plans=tile_plans)


def _autotune_packed_shapes(launches, n_genes: int, hidden: int, device,
                            cache_path: Optional[str]) -> dict:
    """Measure (or load) the packed kernels' plans at (n_genes, hidden) on
    the card for each ``(row count, direction)`` of ``launches``, each row
    count in the directions it launches; returns ``{str(m): {"fwd":
    layout, "bwd": S, "source": ...}}`` with those directions. Ranks of
    one run share the card: rank 0 alone sweeps or loads and writes the
    file, and hands its plans to the others (source ``"broadcast"``), so
    that no two ranks time kernels against each other and all launch the
    same plan (a replicated run whose ranks split the backward
    differently would drift apart)."""
    from g2vec_tpu_torch.ops import packed_matmul as pm
    from g2vec_tpu_torch.parallel import distributed

    shapes = {}
    for m, direction in launches:
        if m > 0:
            shapes.setdefault(int(m), set()).add(direction)
    multi = distributed.initialized() and distributed.process_count() > 1
    plans = None
    if not multi or distributed.process_index() == 0:
        plans = {}
        for m in sorted(shapes):
            ent = pm._autotune(m, n_genes, hidden, shapes[m], device=device,
                               cache_path=cache_path)
            plans[str(m)] = {**{d: ent[d] for d in pm.DIRECTIONS
                                if d in shapes[m]}, "source": ent["source"]}
    if not multi:
        return plans
    from g2vec_tpu_torch.parallel import hostcomm

    payload = hostcomm.broadcast_bytes(
        "autotune_plans",
        None if plans is None else json.dumps(plans).encode())
    if plans is None:
        tag = pm._autotune_backend_tag(device)
        plans = json.loads(payload)
        for m, plan in plans.items():
            pm._install_tuned(int(m), n_genes, hidden, plan, tag)
            plan["source"] = "broadcast"
    return plans


def check_finite(value: torch.Tensor, what: str) -> None:
    """``--debug-nans``: raise ``FloatingPointError`` naming ``what`` when
    ``value`` holds a NaN or an infinity (the JAX package's
    ``jax_debug_nans`` raises the same type). The read syncs the device,
    which is why only a debug run pays it."""
    if not bool(torch.isfinite(value).all()):
        raise FloatingPointError(f"--debug-nans: non-finite {what}")


def check_gradients(params: Sequence[torch.Tensor], when: str) -> None:
    """``--debug-nans`` after a backward: each of ``[w_ih, w_ho]``'s
    gradients, named (w_ih's comes from the packed-matmul backward)."""
    for name, p in zip(("w_ih", "w_ho"), params):
        check_finite(p.grad, f"gradient of {name} {when}")


@dataclasses.dataclass
class LaneTrainSpec:
    """One lane of :func:`train_cbow_lanes`: its packed paths, labels and
    split/init seed; every other hyperparameter is the bucket's."""

    paths: np.ndarray
    labels: np.ndarray
    seed: int


class _Lane:
    """One lane's part of :func:`train_cbow_lanes`: the solo loop's state
    (parameters, Adam, snapshot, history, the last reported accuracies)
    and its data on the device."""

    def __init__(self, model: CBOW, learning_rate: float, max_epochs: int,
                 y_tr, w_tr, y_val, w_val, x_tr=None, x_val=None):
        self.model = model
        self.params = [model.w_ih, model.w_ho]
        self.adam = _Adam(self.params, learning_rate)
        self.snapshot = [p.detach().clone() for p in self.params]
        self.history: List[dict] = []
        self.before_val, self.before_tr = -1.0, -1.0
        self.stopped_early = False
        self.stop_epoch = max_epochs - 1
        self.training = True
        self.y_tr, self.w_tr, self.y_val, self.w_val = y_tr, w_tr, y_val, w_val
        self.x_tr, self.x_val = x_tr, x_val


def train_cbow_lanes(lanes: Sequence[LaneTrainSpec], *, n_genes: int,
                     hidden: int, learning_rate: float, max_epochs: int,
                     val_fraction: float = 0.2,
                     decision_threshold: float = 0.5,
                     compute_dtype: str = "bfloat16",
                     param_dtype: str = "float32", device="cuda",
                     init: Optional[Sequence[CBOW]] = None,
                     on_epoch: Optional[Callable[[int, int, float, float, float], None]] = None,
                     check: Optional[Callable[[], None]] = None,
                     ) -> Tuple[List[TrainResult], torch.Tensor]:
    """Train B lanes whose path matrices share one shape; returns
    ``(results, emb_stack)``: one :class:`TrainResult` per lane and the
    ``[B, n_genes, hidden]`` float32 stack of their embeddings on the
    device (stage 5 reads it there).

    ``init`` is one :class:`CBOW` per lane in place of the seeded draws
    (the tests pass the JAX package's through
    :func:`g2vec_tpu_torch.weights.params_from_jax`), copied, never
    modified. ``on_epoch(lane, step, acc_val, acc_tr, secs)`` fires for
    each lane each epoch it reports; ``secs`` is the epoch's wall for the
    whole bucket. ``check()`` runs before each epoch. A lane that stops
    takes part in no later launch, and its parameters are not touched
    again.
    """
    dev = resolve_device(device)
    n_lanes = len(lanes)
    if n_lanes < 1:
        raise ValueError("train_cbow_lanes needs at least one lane")
    shapes = {spec.paths.shape for spec in lanes}
    if len(shapes) != 1:
        raise ValueError(
            f"train_cbow_lanes is one shape bucket: all lanes must share "
            f"one path-matrix shape, got {sorted(shapes)}")
    n_paths, nb = lanes[0].paths.shape
    if n_paths < 2:
        raise ValueError(f"need at least 2 paths to split, got {n_paths}")
    if any(spec.paths.dtype != np.uint8 for spec in lanes) \
            or nb != (n_genes + 7) // 8:
        raise ValueError(
            f"n_genes={n_genes} expects uint8 paths of width "
            f"{(n_genes + 7) // 8}, got width {nb}")
    if init is not None and len(init) != n_lanes:
        raise ValueError(f"init has {len(init)} entries for {n_lanes} lanes")
    torch_dtype(compute_dtype)
    pdtype = torch_dtype(param_dtype)

    # ---- per lane: the solo split, packing and init ----
    rows, state = [], []
    for b, spec in enumerate(lanes):
        tr_idx, vl_idx = _split_indices(n_paths, spec.seed, val_fraction)
        p_tr, y_tr, w_tr = _pack_split(spec.paths, spec.labels, tr_idx)
        p_val, y_val, w_val = _pack_split(spec.paths, spec.labels, vl_idx)
        rows.append(_fused_rows(p_tr, p_val, n_genes))
        lane_init = init[b] if init is not None else init_params(
            n_genes, hidden, torch.Generator().manual_seed(spec.seed))
        if tuple(lane_init.w_ih.shape) != (n_genes, hidden):
            raise ValueError(f"lane {b}: init w_ih "
                             f"{tuple(lane_init.w_ih.shape)} vs "
                             f"({n_genes}, {hidden})")
        model = CBOW(
            lane_init.w_ih.detach().to(device=dev, dtype=pdtype).clone(),
            lane_init.w_ho.detach().to(device=dev, dtype=pdtype).clone())
        state.append(_Lane(model, learning_rate, max_epochs,
                           *(torch.from_numpy(a).to(dev)
                             for a in (y_tr, w_tr, y_val, w_val))))
    n_tr = len(tr_idx)
    # [B, train + val rows, padded row bytes]: the lanes' [train | val]
    # rows, which every launch reads in place.
    x_all = torch.from_numpy(np.stack(rows)).to(dev)
    del rows
    if compute_dtype == "float32":
        for b, lane in enumerate(state):
            x_dense = unpack_bits(x_all[b], n_genes, torch.float32)
            lane.x_tr, lane.x_val = x_dense[:n_tr], x_dense[n_tr:]
    logit_threshold = float(np.log(decision_threshold
                                   / (1.0 - decision_threshold)))

    def lane_logits(live: List[int], train: bool):
        """Each live lane's (train logits, val logits, its hidden rows or
        None); at bf16 from one forward launch for all of them."""
        if compute_dtype == "float32":
            out = []
            for b in live:
                lane = state[b]
                with torch.set_grad_enabled(train):
                    logits_tr = lane.model(lane.x_tr, compute_dtype)
                with torch.no_grad():
                    logits_val = lane.model(lane.x_val, compute_dtype)
                out.append((logits_tr, logits_val, None))
            return out
        with torch.no_grad():
            w16 = torch.stack([state[b].model.w_ih for b in live]
                              ).to(torch.bfloat16)
            h_all = packed_matmul_lanes_fwd(x_all, w16, live)
        out = []
        for i, b in enumerate(live):
            # A leaf per lane: its gradient is the cotangent the solo
            # trainer's backward launch receives.
            h = h_all[i].detach().requires_grad_(train)
            with torch.set_grad_enabled(train):
                logits = output_logits(h, state[b].model.w_ho, compute_dtype)
            out.append((logits[:n_tr], logits[n_tr:], h))
        return out

    def accuracy(logits, y, w) -> float:
        return float(accuracy_from_logits(logits.detach(), y, w,
                                          logit_threshold))

    t0 = time.perf_counter()
    for epoch in range(max_epochs + 1):
        live = [b for b in range(n_lanes) if state[b].training]
        if not live:
            break
        if check is not None:
            check()
        train = epoch < max_epochs
        logits = lane_logits(live, train)
        now = time.perf_counter()
        secs, t0 = now - t0, now
        stepping = []          # (lane, its hidden rows) that update
        for b, (logits_tr, logits_val, h) in zip(live, logits):
            lane = state[b]
            if epoch > 0:
                # The solo loop's report and first-dip test of epoch e-1.
                acc_val = accuracy(logits_val, lane.y_val, lane.w_val)
                acc_tr = accuracy(logits_tr, lane.y_tr, lane.w_tr)
                lane.history[-1].update(acc_val=acc_val, acc_tr=acc_tr,
                                        secs=secs)
                if on_epoch is not None:
                    on_epoch(b, epoch - 1, acc_val, acc_tr, secs)
                if acc_val < lane.before_val:
                    lane.stopped_early, lane.training = True, False
                    lane.stop_epoch = epoch - 2
                    continue
                lane.snapshot = [p.detach().clone() for p in lane.params]
                lane.before_val, lane.before_tr = acc_val, acc_tr
            if not train:
                lane.training = False
                continue
            loss = masked_bce_loss(logits_tr, lane.y_tr, lane.w_tr)
            loss.backward()
            lane.history.append({"epoch": epoch, "acc_val": float("nan"),
                                 "acc_tr": float("nan"),
                                 "loss": loss.item(), "secs": 0.0})
            stepping.append((b, h))
        if stepping and compute_dtype != "float32":
            # ONE backward launch for the lanes that update, on the first
            # n_tr rows of each; dW is rounded to W's compute copy (bf16)
            # and back, as the solo autograd path does.
            with torch.no_grad():
                dw = packed_matmul_lanes_bwd(
                    x_all, torch.stack([h.grad[:n_tr] for _, h in stepping]),
                    n_genes, [b for b, _ in stepping])
            for i, (b, _) in enumerate(stepping):
                w_ih = state[b].model.w_ih
                w_ih.grad = dw[i].to(torch.bfloat16).to(w_ih.dtype)
        for b, _ in stepping:
            state[b].adam.step(state[b].params)

    emb_stack = torch.stack([lane.snapshot[0].detach().float()
                             for lane in state])
    emb_host = emb_stack.cpu().numpy()
    results = [TrainResult(
        w_ih=emb_host[b], stop_epoch=lane.stop_epoch,
        stopped_early=lane.stopped_early, acc_val=lane.before_val,
        acc_tr=lane.before_tr, history=lane.history,
        model=CBOW(*lane.snapshot)) for b, lane in enumerate(state)]
    return results, emb_stack
