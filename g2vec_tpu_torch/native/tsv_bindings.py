"""ctypes binding of the port's C++ expression-TSV parser
(``tsv_reader.cpp``).

Built with ``g++`` into the package's ``_build/`` directory at first use
(:mod:`g2vec_tpu_torch.native._build`), as the walk sampler is.
:func:`read_expression` raises ``ValueError`` on malformed input, naming
the file and the line, and ``RuntimeError`` (or ``OSError``) when the
library cannot be built or loaded; ``io.readers.load_expression`` falls
back to the Python parser on the latter only.
"""
from __future__ import annotations

import ctypes
import os
from typing import Tuple

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
