"""Per-stage wall-clock timing (the port's copy of
``g2vec_tpu/utils/timing.py``), with the spans of each stage's parts.

Device work is asynchronous, so a stage that queued kernels is not over
when its Python returns: ``sync`` (``torch.cuda.synchronize`` on a CUDA
run) is called before each stage's clock stops.

:meth:`StageTimer.stage` makes its timer and stage the active ones of the
calling context (a :class:`contextvars.ContextVar`), so code below it
opens a part's span with the module-level :func:`span` and no timer
passed down. A span inside another span on the same thread records under
its parent's path (``walk_g/row_set``); repeats of a path add up.
:class:`~g2vec_tpu_torch.parallel.overlap.OverlapScheduler` runs each task
in a copy of its submitter's context, so a background task's spans land in
the stage that submitted it.

While a ``torch.profiler`` is active in the process, a stage is also a
``stage:<name>`` range and a span a ``span:<stage>/<path>`` range of the
trace, on the clock of its kernels and copies. The profiler records them
on the threads it traces (the one that started it). Without a profiler a
span costs two clock reads and a dict update.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

#: (timer, stage, path of the innermost open span) of the calling context.
_ACTIVE: contextvars.ContextVar[Optional[Tuple["StageTimer", str, str]]] = \
    contextvars.ContextVar("g2vec_stage", default=None)


def _profiler_range(name: str):
    """``record_function(name)`` while a torch profiler is active, else
    nothing. Reads torch's flag only if torch is loaded: a process that
    never imported it profiles nothing."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return contextlib.nullcontext()
    return prof.record_function(name)


class StageTimer:
    """Records (stage, seconds) pairs in order of completion.

    :meth:`annotate` attaches attribution facts to a stage (which parser
    read the input) and :func:`span` the host seconds of its parts, summed
    over repeats in ``span_s`` and counted in ``span_n`` by path; they ride
    the ``done`` metrics event as ``stage_extras`` beside
    ``stage_seconds``.
    """

    def __init__(self, sync: Optional[Callable[[], None]] = None) -> None:
        self.stages: List[Tuple[str, float]] = []
        self.extras: Dict[str, Dict] = {}   # guarded-by: _lock
        self._sync = sync
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time one stage, device sync included; the spans opened below it
        record into it."""
        t0 = time.perf_counter()
        token = _ACTIVE.set((self, name, ""))
        try:
            with _profiler_range(f"stage:{name}"):
                try:
                    yield
                    if self._sync is not None:
                        self._sync()
                finally:
                    self.stages.append((name, time.perf_counter() - t0))
        finally:
            _ACTIVE.reset(token)

    def _add_span(self, stage: str, path: str, seconds: float) -> None:
        # Spans of background tasks record from other threads.
        with self._lock:
            extras = self.extras.setdefault(stage, {})
            span_s = extras.setdefault("span_s", {})
            span_n = extras.setdefault("span_n", {})
            span_s[path] = span_s.get(path, 0.0) + seconds
            span_n[path] = span_n.get(path, 0) + 1

    def annotate(self, name: str, **extras) -> None:
        with self._lock:
            self.extras.setdefault(name, {}).update(extras)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)

    def extras_dict(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: dict(v) for k, v in self.extras.items()}

    @property
    def total(self) -> float:
        return sum(s for _, s in self.stages)


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Host seconds of one part of the active stage (no device sync),
    kept under its path in the stage's ``span_s`` and counted in
    ``span_n``. Outside a stage it does nothing."""
    active = _ACTIVE.get()
    if active is None:
        yield
        return
    timer, stage, parent = active
    path = f"{parent}/{name}" if parent else name
    token = _ACTIVE.set((timer, stage, path))
    t0 = time.perf_counter()
    try:
        with _profiler_range(f"span:{stage}/{path}"):
            yield
    finally:
        timer._add_span(stage, path, time.perf_counter() - t0)
        _ACTIVE.reset(token)
