"""Structured JSONL metrics (``--metrics-jsonl``).

The port's copy of ``g2vec_tpu/utils/metrics.py``: one JSON object per
line, each stamped with wall time and a monotonically increasing sequence
number, so tooling can rebuild a run without parsing its transcript. The
event names and their fields are the JAX package's.
"""
from __future__ import annotations

import json
import threading
import time
from typing import IO, Optional


class MetricsWriter:
    """Append-only JSONL sink; a no-op when constructed with ``None``.

    Thread-safe: overlap tasks may emit into the writer the pipeline's
    main thread uses; a lock keeps every line whole and the sequence
    numbers strictly increasing.
    """

    def __init__(self, path: Optional[str], append: bool = False):
        self._fout: Optional[IO[str]] = (open(path, "a" if append else "w")
                                         if path else None)
        self._seq = 0
        self._lock = threading.Lock()

    def emit(self, event: str, **fields) -> None:
        if self._fout is None:
            return
        with self._lock:
            if self._fout is None:
                return
            record = {"seq": self._seq, "ts": time.time(), "event": event,
                      **fields}
            self._fout.write(json.dumps(record) + "\n")
            self._fout.flush()
            self._seq += 1

    def close(self) -> None:
        with self._lock:
            if self._fout is not None:
                self._fout.close()
                self._fout = None

    def bind_lane(self, lane: str) -> "BoundMetrics":
        """A view that stamps every event with ``lane``."""
        return BoundMetrics(self, lane=lane)

    def bind_job(self, job_id: str) -> "BoundMetrics":
        """A view that stamps every event with ``job_id``."""
        return BoundMetrics(self, job_id=job_id)

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BoundMetrics:
    """A field-stamping ``emit()`` view over a shared :class:`MetricsWriter`.

    Not closable: the writer's owner closes it. Views chain, each
    returning a new view with the union of the stamped fields.
    """

    def __init__(self, writer: MetricsWriter, **fields):
        self._writer = writer
        self._fields = fields

    @property
    def lane(self) -> Optional[str]:
        return self._fields.get("lane")

    @property
    def job_id(self) -> Optional[str]:
        return self._fields.get("job_id")

    def bind_lane(self, lane: str) -> "BoundMetrics":
        return BoundMetrics(self._writer, **{**self._fields, "lane": lane})

    def bind_job(self, job_id: str) -> "BoundMetrics":
        return BoundMetrics(self._writer, **{**self._fields, "job_id": job_id})

    def emit(self, event: str, **fields) -> None:
        self._writer.emit(event, **{**self._fields, **fields})
