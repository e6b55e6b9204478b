"""Stage train of a batch (L4: the lane trainer, every lane's steps),
seconds, the mean over the window's untraced batches
(``BatchResult.stage_seconds``)."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.jobs:
        return None
    return sum(r.stage_seconds["train"] for r in ctx.jobs) / len(ctx.jobs)
