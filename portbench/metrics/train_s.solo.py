"""Stage train (L4: the CBOW trainer on the packed kernels), seconds, the
mean over the window's untraced solo runs."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["train"] for r in ctx.jobs) / len(ctx.jobs)
