"""The peaks and the work counts that the roofline and MFU metrics divide.

Frozen copies of ``chip_smoke.py``'s arithmetic: the peaks (:228-236), the
walker's bytes (``_walk_bytes``, :897-908), the walk states' bytes
(``_states_bytes``, :3509-3522) and the packed products' bytes and adds
(:371-383 for a solo launch, :1586-1593 for a lane launch). Work is
counted from the launches' shapes and what their inputs need, whatever
implements the product.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
# The adds that a packed row's set bits ask for (set bits x H for a
# forward): the sheet's 67 TFLOP/s float32 counts an FMA as two
# operations, and an add is one FMA's work, so 33.5e12 adds a second.
# The kernels run their products on the tensor cores (mma.sync); the count
# is of the work the inputs need, which no implementation can skip.
F32_ADDS_PER_S = 33.5e12
# Dense bf16 on the tensor cores (same sheet): the peak an MFU divides.
BF16_TC_OPS_PER_S = 989e12

P_ROW_ALIGN = 4

_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int64)


def row_bytes(n_genes: int) -> int:
    """A packed row's stride in the kernels: ceil(G / 8) rounded up to a
    multiple of 4 bytes."""
    return -(-((n_genes + 7) // 8) // P_ROW_ALIGN) * P_ROW_ALIGN


def set_bits(rows: np.ndarray) -> int:
    """The set bits of packed rows."""
    return int(_POPCOUNT[np.asarray(rows, np.uint8)].sum())


def fwd_work(m: int, n_genes: int, hidden: int, nnz: int):
    """(bytes, adds) of one forward ``out[M, H] = P[M, G] @ W[G, H]``: P
    packed, W in bf16 and the f32 output each moved once; set bits x H
    adds."""
    return (m * row_bytes(n_genes) + n_genes * hidden * 2 + m * hidden * 4,
            nnz * hidden)


def bwd_work(m: int, n_genes: int, hidden: int, nnz: int):
    """(bytes, adds) of one backward ``dW[G, H] = P[M, G]^T @ dH[M, H]``:
    P packed, dH in bf16 and the f32 dW each moved once."""
    return (m * row_bytes(n_genes) + m * hidden * 2 + n_genes * hidden * 4,
            nnz * hidden)


def bound_s(nbytes: float, adds: float) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM bandwidth and adds over the f32 add rate."""
    return max(nbytes / HBM_BYTES_PER_S, adds / F32_ADDS_PER_S)


def walk_bytes(n_genes: int, n_edges: int, n_walkers: int) -> int:
    """One walk launch's bytes, each once: the CSR (int32 indptr [G + 1],
    int32 indices and float32 weights [E]), each walker's int32 start and
    int64 stream id, and the packed rows written (ceil(G / 8) bytes a
    walker)."""
    return int(4 * (n_genes + 1) + 8 * n_edges + 12 * n_walkers
               + n_walkers * ((n_genes + 7) // 8))


def states_bytes(pos_before, pos_after, csr_nbytes: int,
                 n_genes: int) -> int:
    """One advance of resumable walk states, each byte once: a walker's
    cur, pos and rng read (16 B) with its path prefix (4 B an entry), its
    new entries (4 B each) and cur, pos, rng and status written (17 B),
    the CSR and the availability mask read."""
    pos_before = np.asarray(pos_before, np.int64)
    pos_after = np.asarray(pos_after, np.int64)
    return int(16 * pos_before.size + 4 * pos_before.sum()
               + 4 * (pos_after - pos_before).sum() + 17 * pos_before.size
               + csr_nbytes + n_genes)


def dense_flops(m: int, n_genes: int, hidden: int, backward: bool) -> int:
    """The model's dense operations for one launch over M rows: 2*M*G*H
    for the product, and the head (a forward's logits 2*M*H; a
    backward's W_ho gradient and hidden gradient 4*M*H)."""
    return 2 * m * n_genes * hidden + (4 if backward else 2) * m * hidden
