"""ctypes binding of the port's C++ walk sampler (``walker.cpp``): the
one-shot packed walk, and the resumable walks of the edge partition
(:func:`init_walk_state`, :func:`walk_partial`, :func:`pack_paths`; the
reference's ``g2vec_tpu/native/walker_bindings.py:193-290``).

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
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i32pw, u8pw, u64pw = (
        np.ctypeslib.ndpointer(t, flags=("C_CONTIGUOUS", "WRITEABLE"))
        for t in (np.int32, np.uint8, np.uint64))
    lib.g2v_walk_packed.restype = None
    lib.g2v_walk_packed.argtypes = [
        i32p,                                          # indptr [G+1]
        i32p,                                          # indices [E]
        f32p,                                          # w [E]
        ctypes.c_int32,                                # n_genes
        i32p,                                          # starts [W]
        u64p,                                          # ids [W]
        ctypes.c_int64,                                # n_walkers
        ctypes.c_int32,                                # len_path
        ctypes.c_uint64,                               # seed
        ctypes.c_int32,                                # n_threads
        u8pw,                                          # out [W, nbytes]
        ctypes.c_int64,                                # nbytes
    ]
    lib.g2v_init_walk_state.restype = None
    lib.g2v_init_walk_state.argtypes = [
        ctypes.c_uint64,                               # seed
        u64p,                                          # stream_ids [W]
        ctypes.c_int64,                                # n
        u64pw,                                         # out state [W]
    ]
    lib.g2v_walk_partial.restype = None
    lib.g2v_walk_partial.argtypes = [
        i32p,                                          # indptr [G+1]
        i32p,                                          # indices [E]
        f32p,                                          # w [E]
        ctypes.c_int32,                                # n_genes
        u8p,                                           # avail [G]
        i32pw,                                         # cur [W] (in-out)
        u64pw,                                         # rng [W] (in-out)
        i32pw,                                         # pos [W] (in-out)
        i32pw,                                         # paths [W, L] (in-out)
        ctypes.c_int64,                                # n_walkers
        ctypes.c_int32,                                # len_path
        ctypes.c_int32,                                # n_threads
        u8pw,                                          # status [W] (out)
    ]
    lib.g2v_pack_paths.restype = None
    lib.g2v_pack_paths.argtypes = [
        i32p,                                          # paths [R, L]
        ctypes.c_int64,                                # n_rows
        ctypes.c_int32,                                # len_path
        u8pw,                                          # out [R, nbytes]
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


def _check_csr(indptr: np.ndarray, indices: np.ndarray,
               weights: np.ndarray, n_genes: int) -> None:
    """Every index the C++ dereferences through the CSR, in range."""
    if indptr.shape[0] != n_genes + 1:
        raise ValueError(
            f"indptr has {indptr.shape[0]} entries for {n_genes} genes "
            f"(want n_genes+1)")
    if weights.shape[0] != indices.shape[0]:
        raise ValueError(
            f"weights has {weights.shape[0]} entries for "
            f"{indices.shape[0]} edges")
    if indices.size and (indices.min() < 0 or indices.max() >= n_genes):
        raise ValueError(f"indices contains node ids outside [0, {n_genes})")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0] \
            or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr is not a valid CSR row-pointer array")


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
    if starts.size and (starts.min() < 0 or starts.max() >= n_genes):
        raise ValueError(f"starts contains node ids outside [0, {n_genes})")
    _check_csr(indptr, indices, weights, n_genes)
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


def init_walk_state(seed: int, stream_ids: np.ndarray) -> np.ndarray:
    """Each walker's raw splitmix64 state as :func:`walk_paths_packed`
    seeds it (the xor of the stream id times the golden constant, then
    one discarded draw): resumed from it, :func:`walk_partial` draws the
    uniforms the one-shot sampler would."""
    lib = load_walker()
    stream_ids = np.ascontiguousarray(stream_ids, dtype=np.uint64)
    out = np.empty(stream_ids.shape[0], dtype=np.uint64)
    lib.g2v_init_walk_state(np.uint64(seed & 0xFFFFFFFFFFFFFFFF),
                            stream_ids, np.int64(stream_ids.shape[0]), out)
    return out


def check_walk_states(cur: np.ndarray, rng: np.ndarray, pos: np.ndarray,
                      paths: np.ndarray, n_genes: int, len_path: int) -> None:
    """Walk states the advance may update in place: writable C-contiguous
    arrays of one entry a walker, ``cur`` in [0, n_genes), ``pos`` in [1,
    len_path]."""
    n_walkers = cur.shape[0]
    for name, arr, dt in (("cur", cur, np.int32), ("rng", rng, np.uint64),
                          ("pos", pos, np.int32)):
        if arr.dtype != dt or arr.shape != (n_walkers,) \
                or not arr.flags.c_contiguous or not arr.flags.writeable:
            raise ValueError(
                f"{name} must be writable C-contiguous {np.dtype(dt)} "
                f"[{n_walkers}], got {arr.dtype} {arr.shape}")
    if paths.dtype != np.int32 or paths.shape != (n_walkers, len_path) \
            or not paths.flags.c_contiguous or not paths.flags.writeable:
        raise ValueError(
            f"paths must be writable C-contiguous int32 "
            f"[{n_walkers}, {len_path}], got {paths.dtype} {paths.shape}")
    if n_walkers and (cur.min() < 0 or cur.max() >= n_genes):
        raise ValueError(f"cur contains node ids outside [0, {n_genes})")
    if n_walkers and (pos.min() < 1 or pos.max() > len_path):
        raise ValueError(f"pos outside [1, {len_path}]")


def walk_partial(indptr: np.ndarray, indices: np.ndarray,
                 weights: np.ndarray, n_genes: int, avail: np.ndarray,
                 cur: np.ndarray, rng: np.ndarray, pos: np.ndarray,
                 paths: np.ndarray, len_path: int,
                 n_threads: int = 0) -> np.ndarray:
    """Advance explicit-state walks over an availability-masked CSR.

    ``cur``/``rng``/``pos``/``paths`` are updated in place; returns the
    [n_walkers] uint8 status: 0 when the walk finished (full length or
    dead end), 1 when it suspended because ``avail[cur]`` is 0 (the rank
    holding ``cur``'s row must resume it). Rows with ``avail[g] == 0``
    may be empty in the CSR; they are never scanned.
    """
    if len_path < 1:
        raise ValueError(f"len_path must be >= 1, got {len_path}")
    lib = load_walker()
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    avail = np.ascontiguousarray(avail, dtype=np.uint8)
    n_walkers = cur.shape[0]
    _check_csr(indptr, indices, weights, n_genes)
    if avail.shape[0] != n_genes:
        raise ValueError(
            f"avail has {avail.shape[0]} entries for {n_genes} genes")
    check_walk_states(cur, rng, pos, paths, n_genes, len_path)
    if n_threads < 0:
        raise ValueError(f"n_threads must be >= 0, got {n_threads}")
    status = np.empty(n_walkers, dtype=np.uint8)
    lib.g2v_walk_partial(
        indptr, indices, weights, np.int32(n_genes), avail, cur, rng, pos,
        paths, np.int64(n_walkers), np.int32(len_path), np.int32(n_threads),
        status)
    return status


def pack_paths(paths: np.ndarray, n_genes: int,
               out: "np.ndarray | None" = None) -> np.ndarray:
    """Pack [R, len_path] int32 paths (-1 after the end) into
    :func:`walk_paths_packed`'s np.packbits rows: the same bytes for the
    same gene sets. ``out`` may be a row slice of a larger matrix."""
    lib = load_walker()
    paths = np.ascontiguousarray(paths, dtype=np.int32)
    if paths.ndim != 2:
        raise ValueError(f"paths must be [R, len_path], got {paths.shape}")
    n_rows, len_path = paths.shape
    live = paths[paths >= 0]
    if live.size and live.max() >= n_genes:
        raise ValueError(f"paths contains node ids outside [0, {n_genes})")
    nbytes = (n_genes + 7) // 8
    if out is None:
        out = np.empty((n_rows, nbytes), dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (n_rows, nbytes)
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(
            f"out must be writable C-contiguous uint8 [{n_rows}, {nbytes}], "
            f"got {out.dtype} {out.shape}")
    lib.g2v_pack_paths(paths, np.int64(n_rows), np.int32(len_path), out,
                       np.int64(nbytes))
    return out
