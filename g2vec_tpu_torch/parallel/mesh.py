"""The ``(data, model)`` mesh context of a ``--mesh`` run.

The port's copy of ``g2vec_tpu/parallel/mesh.py``. The reference hands its
specs to XLA, which inserts the collectives a sharded program needs; the
port runs no sharded program (a rank trains the whole model on its one
device), so here a spec is plain data: for each dimension of an array,
the mesh axis it is split over, or None. The context keeps the grid of
``torch.device`` objects its run holds and the reference's canonical
specs, which say how a mesh over several devices would lay the trainer
out. ``make_mesh_context(None)`` is the no-mesh context every call site
takes unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: A partition spec: per array dimension, the axis it is split over.
Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh (a ``[data, model]`` grid of devices, or None) and the
    reference's canonical specs."""

    mesh: Optional[np.ndarray]

    # ---- specs ----
    @property
    def batch_spec(self) -> Spec:
        """Multi-hot path batch X [paths, genes]: rows over data, genes
        over model."""
        return (DATA_AXIS, MODEL_AXIS)

    @property
    def label_spec(self) -> Spec:
        return (DATA_AXIS, None)

    @property
    def w_ih_spec(self) -> Spec:
        """Embedding table [genes, hidden]: rows over model."""
        return (MODEL_AXIS, None)

    @property
    def w_ho_spec(self) -> Spec:
        return (None, None)

    @property
    def hidden_spec(self) -> Spec:
        """Activations H [paths, hidden] after the sum over model."""
        return (DATA_AXIS, None)

    @property
    def adj_spec(self) -> Spec:
        """Dense transition matrix [genes, genes]: rows over model."""
        return (MODEL_AXIS, None)

    @property
    def walker_spec(self) -> Spec:
        """Walker state [walkers, ...]: over data."""
        return (DATA_AXIS, None)

    @property
    def packed_batch_spec(self) -> Spec:
        """Bit-packed path batch [paths, bytes]: rows over data; the byte
        axis is never split (a kernel takes whole rows)."""
        return (DATA_AXIS, None)

    # ---- shape ----
    @property
    def shape(self) -> Optional[Tuple[int, int]]:
        return None if self.mesh is None else tuple(self.mesh.shape)

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.size)


def visible_devices(device=None) -> list:
    """The devices a mesh may take in this process: every visible card
    for a cuda run (the default when a card is there), else the CPU, one
    device."""
    import torch

    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh_context(mesh_shape: Optional[Tuple[int, int]],
                      devices: Optional[Sequence] = None) -> MeshContext:
    """A ``(data, model)`` mesh over ``devices`` (by default
    :func:`visible_devices`), or the no-mesh context when the shape is
    None."""
    if mesh_shape is None:
        return MeshContext(mesh=None)
    devices = list(devices if devices is not None else visible_devices())
    need = mesh_shape[0] * mesh_shape[1]
    if len(devices) < need:
        raise ValueError(
            f"mesh {tuple(mesh_shape)} needs {need} devices, only "
            f"{len(devices)} visible")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return MeshContext(mesh=grid.reshape(tuple(mesh_shape)))


def pad_to_multiple(n: int, k: int) -> int:
    """The smallest multiple of k that is >= n (shard-even padding)."""
    return ((n + k - 1) // k) * k
