"""Faults planted in the port underneath a run, for the check that the
judge finds them (``calibrate.py --fault``, ``tests/``). Each takes a
``patch`` object with ``setattr(obj, name, value)`` (pytest's
``monkeypatch``, or :class:`Patch`) and replaces one function of the
port for as long as the patch holds."""
from __future__ import annotations


class Patch:
    """``setattr`` that ``undo`` reverts."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def unchanged_step(patch):
    """Every optimiser step leaves the parameters as they were."""
    from g2vec_tpu_torch.train import trainer

    def step(self, params):
        self.count += 1
        for p in params:
            p.grad = None

    patch.setattr(trainer._Adam, "step", step)


def half_batch(patch):
    """The training loss is the mean over the first half of the batch."""
    from g2vec_tpu_torch.train import trainer

    loss = trainer.masked_bce_loss

    def half(logits, y, w):
        n = logits.shape[0] // 2
        return loss(logits[:n], y[:n], w[:n])

    patch.setattr(trainer, "masked_bce_loss", half)


def altered_lgroup(patch):
    """One gene's L-group is altered where it is produced."""
    from g2vec_tpu_torch import analysis

    find = analysis.find_lgroups

    def altered(*a, **k):
        lg, centres = find(*a, **k)
        lg = lg.clone()
        lg[0] = (lg[0] + 1) % 3
        return lg, centres

    patch.setattr(analysis, "find_lgroups", altered)


def kmeans_no_lloyd(patch):
    """k-means keeps its k-means++ draws: no Lloyd step."""
    from g2vec_tpu_torch import analysis

    kmeans = analysis.kmeans

    def no_steps(x, k, **kw):
        return kmeans(x, k, **dict(kw, iters=0))

    patch.setattr(analysis, "kmeans", no_steps)


def kmeans_worst_restart(patch):
    """k-means keeps the restart of the most inertia."""
    from g2vec_tpu_torch.ops import kmeans as km

    lloyd = km._lloyd

    def worst(x, centers0, iters):
        centers, inertia = lloyd(x, centers0, iters)
        return centers, -inertia

    patch.setattr(km, "_lloyd", worst)


def kmeans_wrong_seed(patch):
    """k-means draws its restarts from the next seed."""
    import torch

    from g2vec_tpu_torch import analysis

    kmeans = analysis.kmeans

    def reseeded(x, k, *, generator, **kw):
        gen = torch.Generator().manual_seed(generator.initial_seed() + 1)
        return kmeans(x, k, generator=gen, **kw)

    patch.setattr(analysis, "kmeans", reseeded)


FAULTS = {f.__name__: f for f in (unchanged_step, half_batch, altered_lgroup,
                                  kmeans_no_lloyd, kmeans_worst_restart,
                                  kmeans_wrong_seed)}
