"""The trainer's product over a bit-packed 0/1 matrix, on Hopper kernels.

``packed_matmul(P, W)`` computes ``unpack(P) @ bf16(W)`` in f32, where P
is ``[M, ceil(G/8)]`` uint8 in np.packbits order (gene g is bit 7-(g&7) of
byte g>>3 — the order the walker writes). It replaces the two Pallas
kernels of ``g2vec_tpu/ops/packed_matmul.py``:

- forward ``packed_matmul_fwd``: ``out [M, H] f32 = unpack(P) @ bf16(W)``
  (``_fwd_call``/``_fwd_kernel``, pallas_call at :302);
- backward ``packed_matmul_bwd``: ``dW [G, H] f32 = unpack(P)^T @
  bf16(g_out)`` (``_bwd_call``/``_bwd_kernel``, pallas_call at :323).

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel of ``csrc/packed_matmul.cu``
(built with nvcc for sm_90a at first use, bound with ctypes, launched on
torch's current stream) or raises; a CPU tensor takes the plain PyTorch
version below, which unpacks the bits to a dense bf16 matrix and computes
``x.float() @ w.bfloat16().float()``. There is no fallback from one to the
other. Each wrapper counts its kernel launches in ``.launches``.

P may come with each row padded by zero bytes to a multiple of
``P_ROW_ALIGN`` (4) bytes, as the trainer builds it once per run: the
kernels copy P in 4-byte words, and take such a P as it is. An unpadded
P of a gene count that needs padding is copied to the padded width on
every launch. The plain versions read the first ``ceil(G/8)`` bytes of a
row either way.

On the card any hidden width H is taken: the wrapper zero-pads the bf16
operand's columns to a multiple of 8 (the kernels' 16-byte copies) and
slices the padding off the result; zero columns add nothing, so this is
exact. The forward launches one block per tile of rows and columns
(:func:`_fwd_grid` counts them and their waves). The backward splits M
into the slices that :func:`_bwd_slices` plans and adds their partials in
a fixed order on the card.

The :class:`PackedMatmul` autograd function glues the two together: the
gradient reaches W only (the paths are data, ref: G2Vec.py:264), the
cotangent is cast to bf16 before the backward, dW is cast back to W's
dtype, and ``grad_rows`` restricts the backward to the first rows (the
trainer's fused [train | val] forward trains on the train rows only).
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from g2vec_tpu_torch.native._build import build, load

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "packed_matmul.cu")

#: The TPU functions these kernels replace (file:line of the pallas_call).
REPLACES = {"packed_matmul_fwd": "g2vec_tpu/ops/packed_matmul.py:302",
            "packed_matmul_bwd": "g2vec_tpu/ops/packed_matmul.py:323"}


def nvcc_command() -> list:
    """nvcc straight to a plain-C shared library for sm_90a (seconds to
    build, where a source including PyTorch's headers takes minutes).
    ``-Xptxas -v`` keeps the register/spill report in the build log."""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _configure(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.g2v_pm_fwd.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
    lib.g2v_pm_fwd_occupancy.argtypes = []
    lib.g2v_pm_fwd_occupancy.restype = ctypes.c_int
    lib.g2v_pm_bwd.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                               i64, i64, ptr]
    for fn in (lib.g2v_pm_fwd, lib.g2v_pm_bwd):
        fn.restype = ctypes.c_int


def build_kernels():
    """Compile the kernels now; returns ``(library path, nvcc output)``."""
    return build(SRC, nvcc_command())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    return load(SRC, nvcc_command(), _configure)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card-side reference).
# ---------------------------------------------------------------------------

#: The kernels copy P in words of this many bytes: its row stride must be
#: a multiple of it.
P_ROW_ALIGN = 4


def padded_row_bytes(n_genes: int) -> int:
    """A packed row of ``n_genes`` bits padded to the kernels' row
    stride: ``ceil(G/8)`` rounded up to a multiple of ``P_ROW_ALIGN``."""
    return -(-((n_genes + 7) // 8) // P_ROW_ALIGN) * P_ROW_ALIGN


def unpack_bits(packed: torch.Tensor, n_genes: int,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[M, ceil(G/8)] uint8 np.packbits rows -> [M, G] 0/1 in ``dtype``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_genes].to(dtype)


def packed_matmul_fwd_plain(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x = unpack_bits(packed, w.shape[0])
    return x.float() @ w.bfloat16().float()


def packed_matmul_bwd_plain(packed: torch.Tensor, g_out: torch.Tensor,
                            n_genes: int) -> torch.Tensor:
    x = unpack_bits(packed, n_genes)
    return x.float().T @ g_out.bfloat16().float()


# ---------------------------------------------------------------------------
# The forward's grid.
# ---------------------------------------------------------------------------

#: The forward kernel's block tile and residency (kFwdRows, kFwdCols and
#: kFwdBlocksPerSM in csrc/packed_matmul.cu, which
#: tests/test_torch_packed_matmul.py holds these equal to).
FWD_BLOCK_ROWS, FWD_BLOCK_COLS, FWD_BLOCKS_PER_SM = 128, 128, 2


class FwdGrid(NamedTuple):
    """A forward launch: ``blocks`` blocks of FWD_BLOCK_ROWS rows x
    FWD_BLOCK_COLS columns, ``waves`` times the card's resident block
    slots."""

    blocks: int
    waves: float


def _fwd_grid(m: int, h: int, n_sms: int) -> FwdGrid:
    """The forward's launch of ``m`` rows and ``h`` columns on ``n_sms``
    SMs. Every block walks every gene in one order for each of its rows,
    so a row's result does not depend on the grid."""
    blocks = -(-m // FWD_BLOCK_ROWS) * -(-h // FWD_BLOCK_COLS)
    return FwdGrid(blocks, blocks / (FWD_BLOCKS_PER_SM * n_sms))


def fwd_occupancy(lib: Optional[ctypes.CDLL] = None) -> int:
    """Blocks of the forward (in ``lib``, by default the port's kernel
    library) that the card keeps resident on one SM."""
    n = (lib or _lib()).g2v_pm_fwd_occupancy()
    if n < 0:
        raise RuntimeError("the forward's occupancy query failed")
    return n


# ---------------------------------------------------------------------------
# The backward's split of M.
# ---------------------------------------------------------------------------

#: The backward kernel's block tile, ring stage and residency (kBwdGenes,
#: kBwdCols, kBwdRows and kBwdBlocksPerSM in csrc/packed_matmul.cu, which
#: tests/test_torch_packed_matmul.py holds these equal to).
BWD_BLOCK_GENES, BWD_BLOCK_COLS, BWD_STAGE_ROWS = 128, 128, 64
BWD_BLOCKS_PER_SM = 2
#: The first pass is planned to fill at most this many waves of resident
#: blocks.
BWD_WAVES = 2
#: A slice is never planned below this many rows.
BWD_MIN_SLICE_ROWS = 1024
#: The planned workspace ([S, G, H8] f32) stays at or under this many bytes.
BWD_WORKSPACE_CAP = 256 * 2 ** 20


class BwdSlices(NamedTuple):
    """Slice ``s`` covers rows ``[s * rows, min(m, (s + 1) * rows))``."""

    n_slices: int
    rows: int
    workspace_bytes: int

    def bounds(self, m: int) -> list:
        return [(s * self.rows, min(m, (s + 1) * self.rows))
                for s in range(self.n_slices)]


def _bwd_split(m: int, n: int, g: int, h8: int) -> BwdSlices:
    """M rows in at most ``n`` slices of whole ring stages, ascending and
    contiguous, none empty; the workspace for ``g`` genes and ``h8``
    columns."""
    rows = -(-max(-(-m // max(n, 1)), 1) // BWD_STAGE_ROWS) * BWD_STAGE_ROWS
    n = max(-(-m // rows), 1)
    return BwdSlices(n, rows, n * g * h8 * 4 if n > 1 else 0)


def _bwd_slices(m: int, g: int, h: int, n_sms: int) -> BwdSlices:
    """How the backward splits its M rows: as many slices as fill the
    card's resident blocks in ``BWD_WAVES`` waves, none planned below
    ``BWD_MIN_SLICE_ROWS`` rows, the workspace within
    ``BWD_WORKSPACE_CAP``. Two waves leave fewer block slots idle than one
    (at the example shape 506 of 528 slots against 230 of 264), and a
    third adds more slices to sum than it fills. The plan depends on its
    arguments alone, so dW is the same bits from run to run. With one
    slice the kernel writes dW directly and needs no workspace."""
    h8 = -(-h // 8) * 8
    tiles = -(-g // BWD_BLOCK_GENES) * -(-h8 // BWD_BLOCK_COLS)
    n = max(1, min(BWD_WAVES * BWD_BLOCKS_PER_SM * n_sms // max(tiles, 1),
                   m // BWD_MIN_SLICE_ROWS,
                   BWD_WORKSPACE_CAP // max(g * h8 * 4, 1)))
    return _bwd_split(m, n, g, h8)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel.
# ---------------------------------------------------------------------------

def _check(packed: torch.Tensor, dense: torch.Tensor, n_genes: int,
           dense_rows: int, what: str) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if dense.dim() != 2 or dense.shape[0] != dense_rows:
        raise ValueError(f"{what} must be [{dense_rows}, H], got "
                         f"{tuple(dense.shape)}")
    nb = (n_genes + 7) // 8
    if packed.shape[1] not in (nb, padded_row_bytes(n_genes)):
        raise ValueError(f"packed width {packed.shape[1]} does not hold "
                         f"{n_genes} genes (want {nb}, or "
                         f"{padded_row_bytes(n_genes)} with its rows padded "
                         f"to a multiple of {P_ROW_ALIGN} bytes)")
    if packed.device != dense.device:
        raise ValueError(f"packed on {packed.device}, {what} on {dense.device}")
    if not dense.dtype.is_floating_point:
        raise ValueError(f"{what} must be floating point, got {dense.dtype}")


def _pad_cols(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with zero columns appended up to a multiple of ``multiple``
    (``t`` itself when its width is one already)."""
    extra = -t.shape[1] % multiple
    return F.pad(t, (0, extra)) if extra else t


def _check_kernel_args(packed: torch.Tensor, dense_bf16: torch.Tensor,
                       what: str, align: int) -> None:
    """What the kernels take beyond :func:`_check`: CUDA tensors, both
    contiguous, and the bf16 operand starting ``align``-byte aligned (the
    width of the kernel's loads)."""
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    if not packed.is_contiguous() or not dense_bf16.is_contiguous():
        raise ValueError(f"the kernel needs contiguous packed and {what}")
    if dense_bf16.data_ptr() % align:
        raise ValueError(f"the kernel needs {what} {align}-byte aligned, "
                         f"got address {dense_bf16.data_ptr():#x}")
    if max(*packed.shape, *dense_bf16.shape) * 8 >= 2 ** 31:
        raise ValueError(f"the kernel indexes rows, genes and columns as "
                         f"int32; got packed {tuple(packed.shape)}, {what} "
                         f"{tuple(dense_bf16.shape)}")


def _launch(fn, *args) -> None:
    """``fn(*args, stream)`` on torch's current stream of the device that
    ``args[0]`` lies on; tensors pass as their data pointers, None as
    NULL."""
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def _padded_packed(packed: torch.Tensor) -> torch.Tensor:
    """P for the kernels' 4-byte copies: its rows padded to a multiple of
    ``P_ROW_ALIGN`` bytes (a copy only when they are not: the trainer
    pads once per run), starting 4-byte aligned or refused."""
    p4 = _pad_cols(packed, P_ROW_ALIGN)
    if p4.data_ptr() % P_ROW_ALIGN:
        raise ValueError(f"the kernels need packed {P_ROW_ALIGN}-byte "
                         f"aligned, got address {p4.data_ptr():#x}")
    return p4


def packed_matmul_fwd(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``unpack(packed) @ bf16(w)`` -> [M, H] float32."""
    _check(packed, w, w.shape[0], w.shape[0], "w")
    if packed.device.type == "cpu":
        return packed_matmul_fwd_plain(packed, w)
    w16 = _pad_cols(w.to(torch.bfloat16), 8)
    _check_kernel_args(packed, w16, "w", 16)
    m, h = packed.shape[0], w.shape[1]
    if m == 0:
        return torch.empty((0, h), dtype=torch.float32, device=packed.device)
    out = _fwd_on_card(packed, w16)
    packed_matmul_fwd.launches += 1
    return out if w16.shape[1] == h else out[:, :h].contiguous()


packed_matmul_fwd.launches = 0


def _fwd_on_card(packed: torch.Tensor, w16: torch.Tensor,
                 lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """The forward kernel (in ``lib``, by default the port's kernel
    library) on checked card tensors (``w16`` padded to a multiple of 8
    columns, at least one row): out [M, w16 width]. Counts nothing: the
    wrapper counts."""
    p4 = _padded_packed(packed)
    m, (g, h8) = packed.shape[0], w16.shape
    out = torch.empty((m, h8), dtype=torch.float32, device=packed.device)
    _launch((lib or _lib()).g2v_pm_fwd, p4, w16, out, m, g, p4.shape[1], h8)
    return out


def packed_matmul_bwd(packed: torch.Tensor, g_out: torch.Tensor,
                      n_genes: int) -> torch.Tensor:
    """``unpack(packed)^T @ bf16(g_out)`` -> [n_genes, H] float32."""
    _check(packed, g_out, n_genes, packed.shape[0], "g_out")
    if packed.device.type == "cpu":
        return packed_matmul_bwd_plain(packed, g_out, n_genes)
    g16 = _pad_cols(g_out.to(torch.bfloat16), 8)
    _check_kernel_args(packed, g16, "g_out", 16)
    m, h = packed.shape[0], g_out.shape[1]
    plan = _bwd_slices(m, n_genes, h, _sm_count(packed.device.index))
    out = _bwd_on_card(packed, g16, n_genes, plan)
    packed_matmul_bwd.launches += 1
    return out if g16.shape[1] == h else out[:, :h].contiguous()


packed_matmul_bwd.launches = 0


def _bwd_on_card(packed: torch.Tensor, g16: torch.Tensor, n_genes: int,
                 plan: BwdSlices) -> torch.Tensor:
    """The backward kernels on checked card tensors (``g16`` padded to a
    multiple of 8 columns) under the split ``plan``: dW [n_genes, g16
    width]. Counts nothing: the wrapper counts."""
    m, h8 = packed.shape[0], g16.shape[1]
    if plan.n_slices < 1 or plan.rows * plan.n_slices < m:
        raise ValueError(f"the split {plan} does not cover {m} rows")
    p4 = _padded_packed(packed)
    out = torch.empty((n_genes, h8), dtype=torch.float32, device=packed.device)
    work = (torch.empty((plan.n_slices, n_genes, h8), dtype=torch.float32,
                        device=packed.device) if plan.n_slices > 1 else None)
    _launch(_lib().g2v_pm_bwd, p4, g16, out, work, m, n_genes, p4.shape[1],
            h8, plan.rows, plan.n_slices)
    return out


def reset_launch_counts() -> None:
    packed_matmul_fwd.launches = 0
    packed_matmul_bwd.launches = 0


class PackedMatmul(torch.autograd.Function):
    """``unpack(packed) @ bf16(w)`` with a gradient for ``w`` only."""

    @staticmethod
    def forward(ctx, packed, w, grad_rows):
        ctx.save_for_backward(packed)
        ctx.n_genes, ctx.w_dtype = w.shape[0], w.dtype
        ctx.grad_rows = packed.shape[0] if grad_rows is None else grad_rows
        return packed_matmul_fwd(packed, w)

    @staticmethod
    def backward(ctx, g_out):
        (packed,) = ctx.saved_tensors
        rows = ctx.grad_rows
        dw = packed_matmul_bwd(packed[:rows], g_out[:rows].contiguous(),
                               ctx.n_genes)
        return None, dw.to(ctx.w_dtype), None


def packed_matmul(packed: torch.Tensor, w: torch.Tensor,
                  grad_rows: Optional[int] = None) -> torch.Tensor:
    """Differentiable ``unpack(packed) @ bf16(w)`` -> [M, H] float32; the
    backward covers rows ``[0, grad_rows)`` (default: all)."""
    if grad_rows is not None and not 0 <= grad_rows <= packed.shape[0]:
        raise ValueError(f"grad_rows {grad_rows} outside [0, {packed.shape[0]}]")
    return PackedMatmul.apply(packed, w, grad_rows)
