"""Stage lgroups of a batch (L5: every lane's k-means), seconds, the mean
over the window's untraced batches."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["lgroups"] for r in ctx.jobs) / len(ctx.jobs)
