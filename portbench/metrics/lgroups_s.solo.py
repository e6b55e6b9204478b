"""Stage lgroups (L5: k-means and the vote), seconds, the mean over the
window's untraced solo runs."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["lgroups"] for r in ctx.jobs) / len(ctx.jobs)
