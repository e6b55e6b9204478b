"""Stage save (L7: the three output files), seconds, the mean over the
window's untraced solo runs."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["save"] for r in ctx.jobs) / len(ctx.jobs)
