"""The window's seconds over the whole jobs it completed: the time a user
waits for one run."""


def read(ctx):
    if not ctx.records:
        return None
    return ctx.window_s / len(ctx.records)
