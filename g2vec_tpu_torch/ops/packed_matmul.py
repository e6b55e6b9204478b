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
from typing import Optional

import torch

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
    for fn in (lib.g2v_pm_fwd, lib.g2v_pm_bwd):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]


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
    if packed.shape[1] != (n_genes + 7) // 8:
        raise ValueError(f"packed width {packed.shape[1]} does not hold "
                         f"{n_genes} genes (want {(n_genes + 7) // 8})")
    if packed.device != dense.device:
        raise ValueError(f"packed on {packed.device}, {what} on {dense.device}")
    if not dense.dtype.is_floating_point:
        raise ValueError(f"{what} must be floating point, got {dense.dtype}")


def _check_kernel_args(packed: torch.Tensor, dense_bf16: torch.Tensor,
                       what: str) -> None:
    """What the kernels take beyond :func:`_check`: CUDA tensors, both
    contiguous, and the bf16 operand in 8-byte rows (four columns per
    load) that start 8-byte aligned."""
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    if not packed.is_contiguous() or not dense_bf16.is_contiguous():
        raise ValueError(f"the kernel needs contiguous packed and {what}")
    if dense_bf16.shape[1] % 4:
        raise ValueError(f"the kernel needs H % 4 == 0 (8-byte bf16 loads), "
                         f"got H={dense_bf16.shape[1]}")
    if dense_bf16.data_ptr() % 8:
        raise ValueError(f"the kernel needs {what} 8-byte aligned, got "
                         f"address {dense_bf16.data_ptr():#x}")
    if max(*packed.shape, *dense_bf16.shape) * 8 >= 2 ** 31:
        raise ValueError(f"the kernel indexes rows, genes and columns as "
                         f"int32; got packed {tuple(packed.shape)}, {what} "
                         f"{tuple(dense_bf16.shape)}")


def _launch(fn, packed, dense_bf16, out, m, g, h) -> None:
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = fn(packed.data_ptr(), dense_bf16.data_ptr(), out.data_ptr(),
                m, g, packed.shape[1], h, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def packed_matmul_fwd(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``unpack(packed) @ bf16(w)`` -> [M, H] float32."""
    _check(packed, w, w.shape[0], w.shape[0], "w")
    if packed.device.type == "cpu":
        return packed_matmul_fwd_plain(packed, w)
    w16 = w.to(torch.bfloat16)
    _check_kernel_args(packed, w16, "w")
    m, (g, h) = packed.shape[0], w.shape
    out = torch.empty((m, h), dtype=torch.float32, device=packed.device)
    if m == 0:
        return out
    _launch(_lib().g2v_pm_fwd, packed, w16, out, m, g, h)
    packed_matmul_fwd.launches += 1
    return out


packed_matmul_fwd.launches = 0


def packed_matmul_bwd(packed: torch.Tensor, g_out: torch.Tensor,
                      n_genes: int) -> torch.Tensor:
    """``unpack(packed)^T @ bf16(g_out)`` -> [n_genes, H] float32."""
    _check(packed, g_out, n_genes, packed.shape[0], "g_out")
    if packed.device.type == "cpu":
        return packed_matmul_bwd_plain(packed, g_out, n_genes)
    g16 = g_out.to(torch.bfloat16)
    _check_kernel_args(packed, g16, "g_out")
    h = g_out.shape[1]
    out = torch.empty((n_genes, h), dtype=torch.float32, device=packed.device)
    _launch(_lib().g2v_pm_bwd, packed, g16, out, packed.shape[0], n_genes, h)
    packed_matmul_bwd.launches += 1
    return out


packed_matmul_bwd.launches = 0


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
