"""Span ``read_network`` of stage load (L1 readers: the network file's
parse in Python), seconds: the mean over the untraced solo runs whose
results the window still holds, the kept job and the last, so one or two
samples a run (``spans.held_mean``)."""
from spans import held_mean


def read(ctx):
    return held_mean(ctx, "load", ["read_network"])
