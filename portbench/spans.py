"""The port's own spans of a window's runs, as the per-layer metrics on
them read them.

A solo run's ``PipelineResult.stage_extras[stage]["span_s"]`` holds the
host seconds of each part of the stage (``utils/timing.py`` in the port),
by path: ``read_network``, ``walk_g/row_set``. The window keeps a job's
results only while it may be judged: the job drawn from the seed and the
last job (``harness.run_cell``). So a reading is the mean over the
untraced jobs whose units still hold a result, one or two a run.
"""
from typing import Iterable, Optional


def held_mean(ctx, stage: str, paths: Iterable[str]) -> Optional[float]:
    """Mean over the held results of the untraced solo jobs of the sum of
    ``paths``' seconds in ``stage``; None where no held result has any of
    them (a program without the spans, or another entry)."""
    if ctx.kind != "solo":
        return None
    paths = tuple(paths)
    values = []
    for rec in ctx.jobs:
        if rec.traced is not None:
            continue
        for unit in rec.units:
            if unit.result is None:
                continue
            span_s = unit.result.stage_extras.get(stage, {}).get("span_s",
                                                                  {})
            found = [span_s[p] for p in paths if p in span_s]
            if found:
                values.append(sum(found))
    return sum(values) / len(values) if values else None
