"""The "modified CBOW" — a two-matmul bag-of-genes sigmoid classifier.

Reference architecture (ref: G2Vec.py:231-251): multi-hot gene-set input
``X [batch, n_genes]`` -> hidden ``H = X @ W_ih`` -> scalar logit
``O = H @ W_ho``; no biases, no nonlinearity. The learned ``W_ih
[n_genes, hidden]`` IS the gene-embedding table (ref: G2Vec.py:286).

The arithmetic is ``g2vec_tpu/models/cbow.py``'s: with compute dtype
bfloat16 both operands of each product are rounded to bf16 and the sums
are taken in f32 (on the bit-packed path the first product is the packed
kernel); with float32 everything is f32.
"""
from __future__ import annotations

from math import sqrt

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


class CBOW(nn.Module):
    """Parameters ``w_ih [n_genes, hidden]`` and ``w_ho [hidden, 1]``."""

    def __init__(self, w_ih: torch.Tensor, w_ho: torch.Tensor):
        super().__init__()
        if w_ih.dim() != 2 or w_ho.shape != (w_ih.shape[1], 1):
            raise ValueError(f"w_ih [G, H] and w_ho [H, 1] expected, got "
                             f"{tuple(w_ih.shape)} and {tuple(w_ho.shape)}")
        self.w_ih = nn.Parameter(w_ih)
        self.w_ho = nn.Parameter(w_ho)

    def forward(self, x: torch.Tensor, compute_dtype: str = "bfloat16"
                ) -> torch.Tensor:
        """Dense multi-hot ``x [batch, n_genes]`` -> logits [batch, 1] f32."""
        h = _matmul_f32(x, self.w_ih, compute_dtype)
        return output_logits(h, self.w_ho, compute_dtype)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor, compute_dtype: str
                ) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``compute_dtype`` and the
    sums taken in f32 (JAX's ``preferred_element_type=float32``)."""
    cdt = torch_dtype(compute_dtype)
    return a.to(cdt).float() @ b.to(cdt).float()


def init_params(n_genes: int, hidden: int,
                generator: torch.Generator) -> CBOW:
    """Truncated-normal init on [-2, 2] x 1/sqrt(hidden) (ref:
    G2Vec.py:234-235), float32 on the CPU: drawn from a CPU generator, so
    one seed gives the same init whatever device trains it."""
    std = 1.0 / sqrt(hidden)
    w_ih = torch.empty((n_genes, hidden), dtype=torch.float32)
    w_ho = torch.empty((hidden, 1), dtype=torch.float32)
    nn.init.trunc_normal_(w_ih, 0.0, 1.0, -2.0, 2.0, generator=generator)
    nn.init.trunc_normal_(w_ho, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return CBOW(w_ih * std, w_ho * std)


def output_logits(h: torch.Tensor, w_ho: torch.Tensor,
                  compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Hidden [batch, hidden] -> logits [batch, 1] f32 (ref: G2Vec.py:240)."""
    return _matmul_f32(h, w_ho, compute_dtype)


def masked_bce_loss(logits: torch.Tensor, y: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted-mean sigmoid BCE (optax's sigmoid_binary_cross_entropy,
    ref: the reduce_mean at G2Vec.py:245, generalized to a row mask).
    ``w`` is a [batch, 1] 0/1 row mask; masked rows contribute exactly
    zero to both sums."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    bce = -y * log_p - (1.0 - y) * log_not_p
    return torch.sum(bce * w) / torch.sum(w)


def accuracy_from_logits(logits: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor, logit_threshold: float = 0.0
                         ) -> torch.Tensor:
    """Masked accuracy at a logit threshold; numerator and denominator are
    sums of exact 0/1 terms, so the value is independent of sum order."""
    pred = (logits > logit_threshold).float()
    return torch.sum((pred == y).float() * w) / torch.sum(w)
