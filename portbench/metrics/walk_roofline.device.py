"""The card walker's share of its roofline in the traced solo runs, %:
each launch's bytes (``roofline.walk_bytes``: one launch a group, the
group's thresholded CSR as the reference counts it) over 3.35 TB/s, over
the device time of ``g2v_walk_kernel`` by name in the trace. Only a run
whose walks are on the card has it."""


def read(ctx):
    if ctx.walker != "device" or not ctx.traced:
        return None
    seconds = ctx.trace["kernels"].get("g2v_walk_kernel", [0.0, 0])[0]
    if seconds <= 0:
        return None
    return 100.0 * ctx.walk_bound_s / seconds
