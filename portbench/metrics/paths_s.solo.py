"""Stage paths (L3: the |PCC| graphs, the walks, integration, gene votes),
seconds, the mean over the window's untraced solo runs."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["paths"] for r in ctx.jobs) / len(ctx.jobs)
