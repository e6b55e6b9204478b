"""Runs (solo runs, or lanes of whole batches) completed over the
window's hours."""


def read(ctx):
    if not ctx.records or ctx.window_s <= 0:
        return None
    return sum(len(r.units) for r in ctx.records) * 3600.0 / ctx.window_s
