"""Stage save of a batch (L7: every lane's three files), seconds, the mean
over the window's untraced batches."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["save"] for r in ctx.jobs) / len(ctx.jobs)
