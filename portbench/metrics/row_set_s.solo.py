"""Spans ``walk_g/row_set`` + ``walk_p/row_set`` of stage paths (L3: the
walkers' packed rows made into a Python set of ``bytes``, both walkers),
seconds: the mean over the untraced solo runs whose results the window
still holds, the kept job and the last, so one or two samples a run
(``spans.held_mean``)."""
from spans import held_mean


def read(ctx):
    return held_mean(ctx, "paths", ["walk_g/row_set", "walk_p/row_set"])
