"""The gene-range-split CBOW step of the sharded streaming run.

The port of ``g2vec_tpu/train/shard.py``. The unsharded streaming step
holds the whole ``[G, H]`` embedding on one device; here the step is cut
where cross-rank data flows, the hidden activations. Each rank holds the
byte-aligned gene range ``[lo, hi)`` of ``W_ih``
(:class:`~g2vec_tpu_torch.parallel.shard.ShardSpec`), padded with zero rows
to whole bytes, and a replicated head ``w_ho``. One minibatch step:

1. :func:`partial_hidden <make_split_fns>`: ``h_part = unpack(P_local) @
   W_local`` in f32, over the rank's byte columns of the shard. At bf16 it
   is :func:`~g2vec_tpu_torch.ops.packed_matmul.packed_matmul_fwd`, the
   forward kernel ``pm_fwd_kernel`` on the card.
2. A host allreduce-sum of ``h_part`` in rank order (the caller's
   :class:`~g2vec_tpu_torch.parallel.shard.ShardContext`), so the reduced
   ``h`` is the same bits on every rank.
3. ``head_grads``: the masked BCE and its gradients for ``(w_ho, h)``,
   the same on every rank, which keeps ``w_ho`` replicated with no second
   collective.
4. ``embed_grad``: ``dW_local = unpack(P_local)^T @ dh``, the rank's own
   slice of the gradient. At bf16 it is
   :func:`~g2vec_tpu_torch.ops.packed_matmul.packed_matmul_bwd`
   (``pm_bwd_kernel`` + ``pm_bwd_sum_kernel`` on the card).
5. The caller's Adam step over ``(W_local, w_ho)``.

The arithmetic is :mod:`..models.cbow`'s: at bf16 both operands of each
product are rounded to bf16 and the sums taken in f32; at f32 the dense
``torch.matmul`` path the streaming trainer takes at f32; the decision
threshold is applied in logit space. On the CPU the kernels' plain
versions run. One step costs one ``[rows, H]`` f32 collective, whatever G.

At one rank the trainer never comes here (the byte-identity contract);
at R > 1 the sum order of ``h`` differs from one matmul's, so parity with
the unsharded run is statistical.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from g2vec_tpu_torch.models.cbow import (CBOW, accuracy_from_logits,
                                         init_params, masked_bce_loss,
                                         output_logits)
from g2vec_tpu_torch.ops.packed_matmul import (packed_matmul_bwd,
                                               packed_matmul_fwd, unpack_bits)


class SplitStepFns(NamedTuple):
    partial_hidden: object   # (w_ih_local, x_packed) -> [rows, H] f32
    head_grads: object       # (w_ho, h, y, w) -> (loss, dw_ho, dh)
    embed_grad: object       # (x_packed, dh) -> [g_pad_local, H] f32
    head_eval: object        # (w_ho, h, y, w) -> accuracy f32


def make_split_fns(compute_dtype: str, decision_threshold: float,
                   g_pad_local: int) -> SplitStepFns:
    """The four halves of one split step for a rank whose ``W_ih`` slice
    has ``g_pad_local`` rows (its byte columns x 8). ``x_packed`` may have
    its rows padded to the kernels' 4-byte stride."""
    logit_threshold = float(np.log(decision_threshold
                                   / (1.0 - decision_threshold)))

    def partial_hidden(w_ih_local: torch.Tensor,
                       x_packed: torch.Tensor) -> torch.Tensor:
        if compute_dtype == "float32":
            x = unpack_bits(x_packed, g_pad_local, torch.float32)
            return x @ w_ih_local.float()
        return packed_matmul_fwd(x_packed, w_ih_local)

    def head_grads(w_ho: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor):
        with torch.enable_grad():
            w_ho = w_ho.detach().requires_grad_(True)
            h = h.detach().requires_grad_(True)
            loss = masked_bce_loss(output_logits(h, w_ho, compute_dtype),
                                   y, w)
            dw_ho, dh = torch.autograd.grad(loss, (w_ho, h))
        return loss.detach(), dw_ho, dh

    def embed_grad(x_packed: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
        if compute_dtype == "float32":
            x = unpack_bits(x_packed, g_pad_local, torch.float32)
            return x.T @ dh.float()
        return packed_matmul_bwd(x_packed, dh.contiguous(), g_pad_local)

    def head_eval(w_ho: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
        return accuracy_from_logits(output_logits(h, w_ho, compute_dtype),
                                    y, w, logit_threshold)

    return SplitStepFns(partial_hidden, head_grads, embed_grad, head_eval)


def split_params(full: CBOW, spec) -> CBOW:
    """The rank's share of a full ``[G, H]`` init: its gene range of
    ``w_ih`` with zero rows appended up to the byte-aligned local width,
    and ``w_ho`` whole. A slice of the same draw the unsharded run makes,
    so the sharded run is a perturbation of it (the sum order of ``h``),
    not another model."""
    w_ih = full.w_ih.detach()[spec.lo:spec.hi]
    blo, bhi = spec.byte_range()
    pad = (bhi - blo) * 8 - spec.g_local
    if pad > 0:
        w_ih = torch.cat([w_ih, w_ih.new_zeros((pad, w_ih.shape[1]))])
    return CBOW(w_ih.clone(), full.w_ho.detach().clone())


def init_split_params(n_genes: int, hidden: int, spec,
                      generator: torch.Generator) -> CBOW:
    """:func:`split_params` of the seeded unsharded init: the full table is
    drawn on the CPU once, sliced, and the rest dropped (an init-only
    transient, never on the card)."""
    return split_params(init_params(n_genes, hidden, generator), spec)
