"""ctypes binding of the port's C++ walk sampler (``walker.cpp``).

Built with ``g++`` into the package's ``_build/`` directory at first use
(:mod:`g2vec_tpu_torch.native._build`). This module is the language
boundary, so every index the C++ dereferences is range-checked here.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from g2vec_tpu_torch.native._build import build, load
from g2vec_tpu_torch.resilience.faults import fault_point

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "walker.cpp")
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def _configure(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.g2v_walk_packed.restype = None
    lib.g2v_walk_packed.argtypes = [
        i32p,                                          # indptr [G+1]
        i32p,                                          # indices [E]
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),  # w [E]
        ctypes.c_int32,                                # n_genes
        i32p,                                          # starts [W]
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),   # ids [W]
        ctypes.c_int64,                                # n_walkers
        ctypes.c_int32,                                # len_path
        ctypes.c_uint64,                               # seed
        ctypes.c_int32,                                # n_threads
        np.ctypeslib.ndpointer(np.uint8, flags=("C_CONTIGUOUS", "WRITEABLE")),
        ctypes.c_int64,                                # nbytes
    ]


def build_walker():
    """Compile the sampler now; returns ``(library path, compiler output)``."""
    return build(SRC, COMMAND)


def load_walker() -> ctypes.CDLL:
    """The loaded sampler (built on first use; ``RuntimeError`` when it
    cannot be)."""
    # Fault seam: an injected crash (a RuntimeError) makes the "auto"
    # backend resolve to the card's walker, the way a host without a
    # working toolchain does.
    fault_point("native_walker_load")
    return load(SRC, COMMAND, _configure)


def walk_paths_packed(indptr: np.ndarray, indices: np.ndarray,
                      weights: np.ndarray, n_genes: int, starts: np.ndarray,
                      stream_ids: np.ndarray, len_path: int, seed: int,
                      n_threads: int = 0) -> np.ndarray:
    """Run the sampler -> [n_walkers, ceil(n_genes/8)] uint8 np.packbits
    rows (MSB of byte 0 = gene 0), one per walker, not deduplicated."""
    if len_path < 1:
        raise ValueError(f"len_path must be >= 1, got {len_path}")
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    stream_ids = np.ascontiguousarray(stream_ids, dtype=np.uint64)
    n_walkers = starts.shape[0]
    if stream_ids.shape[0] != n_walkers:
        raise ValueError(
            f"stream_ids has {stream_ids.shape[0]} entries for "
            f"{n_walkers} walkers")
    if indptr.shape[0] != n_genes + 1:
        raise ValueError(
            f"indptr has {indptr.shape[0]} entries for {n_genes} genes "
            f"(want n_genes+1)")
    if weights.shape[0] != indices.shape[0]:
        raise ValueError(
            f"weights has {weights.shape[0]} entries for "
            f"{indices.shape[0]} edges")
    for name, arr in (("starts", starts), ("indices", indices)):
        if arr.size and (arr.min() < 0 or arr.max() >= n_genes):
            raise ValueError(
                f"{name} contains node ids outside [0, {n_genes})")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0] \
            or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr is not a valid CSR row-pointer array")
    if n_threads < 0:
        raise ValueError(f"n_threads must be >= 0, got {n_threads}")
    lib = load_walker()
    nbytes = (n_genes + 7) // 8
    out = np.empty((n_walkers, nbytes), dtype=np.uint8)
    lib.g2v_walk_packed(
        indptr, indices, weights, np.int32(n_genes), starts, stream_ids,
        np.int64(n_walkers), np.int32(len_path),
        np.uint64(seed & 0xFFFFFFFFFFFFFFFF), np.int32(n_threads),
        out, np.int64(nbytes))
    return out
