"""Stage load (L1 readers: the TSV parse), seconds, the mean over the
window's untraced solo runs (``PipelineResult.stage_seconds``)."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["load"] for r in ctx.jobs) / len(ctx.jobs)
