"""Dependency-driven stage overlap (the port's copy of
``g2vec_tpu/parallel/overlap.py``).

Some of a solo run's work is native code that releases the interpreter
lock (the kernels' nvcc build, the C++ parse of the expression file, the
C++ walks); the pipeline runs it on this scheduler's threads while its
own thread goes on (with the card's first use, for one). The scheduler:

- :meth:`OverlapScheduler.submit` registers a named task with optional
  dependencies (names of earlier tasks); it runs on the scheduler's own
  executor as soon as its dependencies resolve.
- :meth:`OverlapScheduler.result` joins a task, re-raising its exception.
- :meth:`OverlapScheduler.prune` joins and forgets the tasks of one name
  prefix (a batch of the engine's long-lived scheduler).
- :meth:`OverlapScheduler.drain` joins everything. On failure the FIRST
  failing task's exception propagates (by submission order), tasks whose
  dependencies failed are cancelled (marked, never started), and no
  thread is left waiting on a task that can no longer run.

Accounting: a background task "saves" the wall time it ran while the
caller was not waiting on it: ``saved = duration - wait``, where wait is
the time :meth:`result`/:meth:`drain` blocked on it (floor 0). The
pipeline reports these as ``overlap_saved_s``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional


class TaskCancelled(RuntimeError):
    """A task never ran because a dependency failed (or drain cancelled
    pending work after a failure)."""


class _Task:
    def __init__(self, name: str, fn: Callable, deps: tuple):
        self.name = name
        self.fn = fn
        self.deps = deps
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.started_at: Optional[float] = None
        self.duration = 0.0
        self.waited = 0.0       # seconds a joiner actually blocked on us


class OverlapScheduler:
    """A tiny named-task DAG over one ThreadPoolExecutor.

    Not a general executor: tasks are few (per-group walks, the device
    warm-up, the streaming producer), names are unique per run, and the scheduling policy is just
    "run when deps are done". That smallness is deliberate — the failure
    semantics (original exception, clean drain) must stay auditable.
    """

    def __init__(self, max_workers: int = 4):
        self._ex = ThreadPoolExecutor(max_workers=max_workers,
                                      thread_name_prefix="g2v-overlap")
        # _lock covers the registry shape (submit/add_closer run on
        # different threads); unlocked READS in result/drain are safe
        # because tasks are never mutated after submit — only their _Task
        # fields change, via each task's own Event.
        self._tasks: Dict[str, _Task] = {}      # guarded-by: _lock
        self._order: list = []                  # guarded-by: _lock
        self._lock = threading.Lock()
        self._closers: list = []                # guarded-by: _lock

    # ---- submission -------------------------------------------------------

    def submit(self, name: str, fn: Callable, *,
               deps: Iterable[str] = ()) -> None:
        """Register ``fn`` to run as soon as every task in ``deps`` has
        succeeded. Dependencies must already be submitted (the pipeline
        builds its DAG top-down)."""
        deps = tuple(deps)
        with self._lock:
            if name in self._tasks:
                raise ValueError(f"duplicate overlap task {name!r}")
            for d in deps:
                if d not in self._tasks:
                    raise ValueError(
                        f"task {name!r} depends on unsubmitted {d!r}")
            task = _Task(name, fn, deps)
            self._tasks[name] = task
            self._order.append(task)
        self._ex.submit(self._run, task)

    def _run(self, task: _Task) -> None:
        try:
            for d in task.deps:
                dep = self._tasks[d]
                dep.done.wait()
                if dep.error is not None:
                    raise TaskCancelled(
                        f"overlap task {task.name!r} cancelled: dependency "
                        f"{d!r} failed ({type(dep.error).__name__})")
            task.started_at = time.perf_counter()
            task.result = task.fn()
        except BaseException as e:  # noqa: BLE001 — joiner re-raises
            task.error = e
        finally:
            if task.started_at is not None:
                task.duration = time.perf_counter() - task.started_at
            task.done.set()

    # ---- joining ----------------------------------------------------------

    def has(self, name: str) -> bool:
        """Whether ``name`` was submitted (conditional joins)."""
        with self._lock:
            return name in self._tasks

    def result(self, name: str):
        """Block until ``name`` finishes; return its value or re-raise its
        exception. The block time is charged to the task's wait account
        (the part of its duration that did NOT overlap useful work)."""
        task = self._tasks[name]
        t0 = time.perf_counter()
        task.done.wait()
        task.waited += time.perf_counter() - t0
        if task.error is not None:
            raise task.error
        return task.result

    def drain(self, raise_errors: bool = True) -> None:
        """Join every submitted task (dependency-cancelled ones included —
        they finish immediately by construction, so this cannot deadlock).
        With ``raise_errors``, re-raise the first REAL failure in
        submission order; TaskCancelled shadows of that failure are
        swallowed (the original exception is the one the caller must see).
        """
        for task in list(self._order):
            t0 = time.perf_counter()
            task.done.wait()
            task.waited += time.perf_counter() - t0
        if not raise_errors:
            return
        for task in list(self._order):
            if task.error is not None and not isinstance(task.error,
                                                         TaskCancelled):
                raise task.error

    def prune(self, prefix: str) -> None:
        """Wait for every task whose name starts with ``prefix`` and forget
        it (its result and error included): a long-lived scheduler, as the
        batch engine keeps, names each batch's tasks under one prefix."""
        for task in list(self._order):       # an unlocked read, as drain's
            if task.name.startswith(prefix):
                task.done.wait()
        with self._lock:
            for task in self._order:
                if task.name.startswith(prefix):
                    del self._tasks[task.name]
            self._order = [t for t in self._order
                           if not t.name.startswith(prefix)]

    def add_closer(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Register an unblocker run at the START of :meth:`close`.

        The sampler->trainer streaming edge (train/stream.py) is the one
        task shape whose thread can legitimately BLOCK mid-run: a shard
        producer parked on a full ring. The plain drain contract ("every
        task finishes") only holds if something wakes it when the
        consumer is gone, so the edge registers its ring's ``cancel``
        here; close() then cannot deadlock on a producer whose consumer
        died in a foreground stage. Closers run in registration order;
        a closer's exception is swallowed (close is a ``finally`` path).
        Returns a deregistration thunk: a finished edge removes its
        closer.
        """
        with self._lock:
            self._closers.append(fn)

        def remove() -> None:
            with self._lock:
                try:
                    self._closers.remove(fn)
                except ValueError:
                    pass
        return remove

    def close(self) -> None:
        """Drain without raising, then shut the executor down. Safe in a
        ``finally``: a pipeline failing in a foreground stage must not
        hang on background tasks at teardown."""
        with self._lock:
            closers = list(self._closers)
        for fn in closers:
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown must proceed
                pass
        self.drain(raise_errors=False)
        self._ex.shutdown(wait=True)

    # ---- accounting -------------------------------------------------------

    def saved_seconds(self) -> Dict[str, float]:
        """Per-task overlap win: run time the caller never waited for."""
        out = {}
        for task in self._order:
            if task.error is not None or task.started_at is None:
                continue
            out[task.name] = round(max(0.0, task.duration - task.waited), 3)
        return out

    def __enter__(self) -> "OverlapScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
