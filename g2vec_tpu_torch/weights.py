"""Parameters of the JAX package -> the port's :class:`CBOW` module.

The two packages draw their seeded inits from different generators, so a
comparison between them starts both from the same arrays: the JAX side
takes them through ``train_cbow(warm_start=...)``, the port through
:func:`params_from_jax`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from g2vec_tpu_torch.models.cbow import CBOW


def params_from_jax(w_ih: np.ndarray, w_ho: np.ndarray,
                    pad_to: Optional[int] = None) -> CBOW:
    """``w_ih [G, H]`` and ``w_ho [H, 1]`` (or ``[H]``), as numpy arrays the
    way ``CBOWParams`` holds them -> a float32 :class:`CBOW` on the CPU
    (``train_cbow`` moves it to its device and dtype); ``pad_to`` appends
    zero rows to ``w_ih`` as the JAX ``init_params(pad_to=...)`` does."""
    wi = torch.tensor(np.asarray(w_ih, dtype=np.float32))
    wo = torch.tensor(np.asarray(w_ho, dtype=np.float32)).reshape(-1, 1)
    if pad_to is not None and pad_to > wi.shape[0]:
        wi = torch.cat([wi, wi.new_zeros((pad_to - wi.shape[0], wi.shape[1]))])
    return CBOW(wi, wo)
