"""The share of the traced batches' wall time in which the card ran no
kernel, copy or memset, % (``tracing.summarize``: the union of the
device's operations over each job's range)."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.traced or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
