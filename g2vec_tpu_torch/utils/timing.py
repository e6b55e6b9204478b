"""Per-stage wall-clock timing (the port's copy of
``g2vec_tpu/utils/timing.py``).

Device work is asynchronous, so a stage that queued kernels is not over
when its Python returns: ``sync`` (``torch.cuda.synchronize`` on a CUDA
run) is called before each stage's clock stops.
"""
from __future__ import annotations

import contextlib
import time
from typing import (Callable, ContextManager, Dict, Iterator, List,
                    Optional, Tuple)


class StageTimer:
    """Records (stage, seconds) pairs in order of completion.

    :meth:`annotate` attaches attribution facts to a stage (which parser
    read the input, how many sampler threads walked) and :meth:`span` the
    host seconds of its parts; they ride the ``done`` metrics event as ``stage_extras`` beside
    ``stage_seconds``.
    """

    def __init__(self, sync: Optional[Callable[[], None]] = None,
                 mark: Optional[Callable[[str], ContextManager]] = None
                 ) -> None:
        self.stages: List[Tuple[str, float]] = []
        self.extras: Dict[str, Dict] = {}
        self._sync = sync
        self._mark = mark

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time one stage; ``mark(name)`` (a profiler range under
        ``--profile-dir``) is entered around it, device sync included."""
        t0 = time.perf_counter()
        with (self._mark(name) if self._mark is not None
              else contextlib.nullcontext()):
            try:
                yield
                if self._sync is not None:
                    self._sync()
            finally:
                self.stages.append((name, time.perf_counter() - t0))

    @contextlib.contextmanager
    def span(self, stage: str, name: str) -> Iterator[None]:
        """Host seconds of one part of ``stage`` (no device sync), kept in
        its extras under ``span_s``; spans may run on other threads."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.extras.setdefault(stage, {}).setdefault("span_s", {})[
                name] = time.perf_counter() - t0

    def annotate(self, name: str, **extras) -> None:
        self.extras.setdefault(name, {}).update(extras)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)

    def extras_dict(self) -> Dict[str, Dict]:
        return {k: dict(v) for k, v in self.extras.items()}

    @property
    def total(self) -> float:
        return sum(s for _, s in self.stages)
