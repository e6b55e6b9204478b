"""Build-and-load for the port's native sources (C++ walker, CUDA kernels).

One contract for every source: compile at first use into the package's
own git-ignored ``_build/`` directory, under a file name keyed on the
source's content, the content of the files it includes (``deps``) and the
full compiler command, so that an edited source or a changed flag misses
and rebuilds while repeat runs load the cached library. The library is written to a temporary name and ``os.replace``d
into place, so concurrent processes never load a half-written file;
within a process one lock makes each library build and load once.
Build failures raise ``RuntimeError`` carrying the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict, List, Sequence, Tuple

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def library_path(src: str, command: List[str],
                 deps: Sequence[str] = ()) -> str:
    """Where ``src`` (including ``deps``) built by ``command`` lives in the
    build directory."""
    h = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(command).encode())
    base = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{base}-{h.hexdigest()[:16]}.so")


def build(src: str, command: List[str], timeout: float = 600.0,
          deps: Sequence[str] = ()) -> Tuple[str, str]:
    """Compile ``src`` with ``command + ["-o", out, src]`` unless the keyed
    library exists. Returns ``(path, compiler output)``; the output is
    empty when the cached library was reused."""
    so = library_path(src, command, deps)
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [*command, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"build failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, proc.stdout + proc.stderr


def load(src: str, command: List[str],
         configure: Callable[[ctypes.CDLL], None],
         deps: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``src`` (built on first use); ``configure``
    declares argtypes/restype once."""
    so = library_path(src, command, deps)
    with _LOCK:
        lib = _LOADED.get(so)
        if lib is None:
            build(src, command, deps=deps)
            lib = ctypes.CDLL(so)
            configure(lib)
            _LOADED[so] = lib
    return lib
