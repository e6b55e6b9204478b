"""Spans ``walk_g/rows_copy`` + ``walk_p/rows_copy`` of stage paths (L3
card walker: the packed rows' device-to-host copy after the walker
kernel), seconds: the mean over the untraced solo runs whose results the
window still holds, the kept job and the last, so one or two samples a
run (``spans.held_mean``). Only the card's walker opens these spans."""
from spans import held_mean


def read(ctx):
    return held_mean(ctx, "paths", ["walk_g/rows_copy", "walk_p/rows_copy"])
