"""ctypes binding of the port's C++ TSV parsers (``tsv_reader.cpp``): the
expression matrix and the network edge list.

Built with ``g++`` into the package's ``_build/`` directory at first use
(:mod:`g2vec_tpu_torch.native._build`), as the walk sampler is.
:func:`read_expression` raises ``ValueError`` on malformed input, naming
the file and the line; :func:`read_network` returns None where the Python
reader must read the file (its errors are the Python reader's). Both raise
``RuntimeError`` (or ``OSError``) when the library cannot be built or
loaded; ``io.readers`` falls back to the Python parser on that only. A
ctypes call releases the interpreter lock, so a parse runs beside Python
threads.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from g2vec_tpu_torch.native._build import build, load
from g2vec_tpu_torch.resilience.faults import fault_point

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "tsv_reader.cpp")
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]


def _configure(lib: ctypes.CDLL) -> None:
    handle = ctypes.c_void_p
    lib.g2v_expr_read.restype = handle
    lib.g2v_expr_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int]
    for fn in (lib.g2v_expr_nsamples, lib.g2v_expr_ngenes):
        fn.restype = ctypes.c_int
        fn.argtypes = [handle]
    for fn in (lib.g2v_expr_sample, lib.g2v_expr_gene):
        fn.restype = ctypes.c_char_p
        fn.argtypes = [handle, ctypes.c_int]
    lib.g2v_expr_copy.restype = None
    lib.g2v_expr_copy.argtypes = [handle, ctypes.POINTER(ctypes.c_float)]
    lib.g2v_expr_free.restype = None
    lib.g2v_expr_free.argtypes = [handle]
    lib.g2v_net_read.restype = handle
    lib.g2v_net_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.g2v_net_nedges, lib.g2v_net_nnames,
               lib.g2v_net_names_size):
        fn.restype = ctypes.c_int64
        fn.argtypes = [handle]
    lib.g2v_net_copy.restype = None
    lib.g2v_net_copy.argtypes = [handle, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.g2v_net_free.restype = None
    lib.g2v_net_free.argtypes = [handle]


def build_tsv_reader():
    """Compile the parser now; returns ``(library path, compiler output)``."""
    return build(SRC, COMMAND)


def _load() -> ctypes.CDLL:
    # Fault seam: an injected crash (a RuntimeError) takes the reader's
    # fallback to the Python parser, the way a broken library would.
    fault_point("native_load")
    return load(SRC, COMMAND, _configure)


def read_expression(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an expression TSV natively -> (samples [S] str, genes [G] str,
    expr [S, G] float32), the arrays the Python reader builds."""
    lib = _load()
    err = ctypes.create_string_buffer(512)
    handle = lib.g2v_expr_read(os.fsencode(path), err, len(err))
    if not handle:
        raise ValueError(err.value.decode() or f"{path}: native parse failed")
    try:
        n_s = lib.g2v_expr_nsamples(handle)
        n_g = lib.g2v_expr_ngenes(handle)
        samples = np.array([lib.g2v_expr_sample(handle, i).decode()
                            for i in range(n_s)])
        genes = np.array([lib.g2v_expr_gene(handle, j).decode()
                          for j in range(n_g)])
        expr = np.empty((n_s, n_g), dtype=np.float32)
        lib.g2v_expr_copy(handle, expr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)))
        return samples, genes, expr
    finally:
        lib.g2v_expr_free(handle)


def read_network(path: str, utf8: bool
                 ) -> Optional[Tuple[List[str], np.ndarray, np.ndarray]]:
    """Parse a network TSV natively -> (names in first-seen order, src
    [E] int32, dst [E] int32), edge i running ``names[src[i]] ->
    names[dst[i]]``; None where the Python reader must read the file
    (``tsv_reader.cpp`` lists those files). ``utf8``: the text encoding
    ``open`` uses is UTF-8 (else only ASCII files are parsed here)."""
    lib = _load()
    handle = lib.g2v_net_read(os.fsencode(path), int(utf8))
    if not handle:
        return None
    try:
        n_edges = lib.g2v_net_nedges(handle)
        names = np.empty(lib.g2v_net_names_size(handle), dtype=np.uint8)
        src = np.empty(n_edges, dtype=np.int32)
        dst = np.empty(n_edges, dtype=np.int32)
        lib.g2v_net_copy(handle, names.ctypes.data, src.ctypes.data,
                         dst.ctypes.data)
        n_names = lib.g2v_net_nnames(handle)
    finally:
        lib.g2v_net_free(handle)
    return (names.tobytes().decode().split("\n") if n_names else [],
            src, dst)
