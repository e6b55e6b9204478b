"""From process start to the window's start, seconds: imports, card
init, the inputs made from the seed, the kernels loaded, the warm-up
job."""


def read(ctx):
    return ctx.setup_s
