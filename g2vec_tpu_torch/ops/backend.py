"""Which sampler walks stage 3 (``--walker-backend``).

The port's copy of ``g2vec_tpu/ops/backend.py:49-91``, single-process.
``auto`` is host-walks-card-trains: the threaded C++ sampler when it
builds on this host, else the card's walker (:mod:`.device_walker`). Both
draw the same splitmix64 walks, byte for byte, so the choice changes
where the walks run, never what they are.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from g2vec_tpu_torch.config import G2VecConfig


def native_walker_available() -> bool:
    """True when the C++ sampler builds and loads here (the first call
    may pay a g++ build of about a second; the library is cached)."""
    from g2vec_tpu_torch.native.walker_bindings import load_walker

    try:
        load_walker()
    except (RuntimeError, OSError):
        return False
    return True


def resolve_walker_backend(cfg: "G2VecConfig") -> str:
    """``cfg.walker_backend`` ("auto" | "device" | "native") -> the
    backend this run walks with. An explicit choice stands as it is: a
    "native" run on a host without g++ raises at the walk with the build
    error rather than move to the card."""
    if cfg.walker_backend != "auto":
        return cfg.walker_backend
    return "native" if native_walker_available() else "device"
